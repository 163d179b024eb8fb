"""Edge->node aggregation primitives (port of graph_weather_tpu/ops/scatter.py).

Both strategies are XLA in the JAX package, so they are plain PyTorch here,
but for the edge-order segment sum, which is a CUDA kernel on the card:

  * `segment_sum_agg`: `index_add_` over the receiver ids, the reference
    the tests hold the fixed-order sums to. On CUDA it adds with atomics,
    so its order, and the last bits of the result, change from run to run:
    no model path of the port takes it.
  * `edge_order_sum` ("S", csrc/segment_sum.cu): the sum of XLA's
    `segment_sum`, and of the gradient of `jnp.take` (a scatter-add): each
    node's edges one at a time, in edge order, over a flat CSR
    (`build_flat_csr`: offsets [N + 1], edge ids [E]); in bf16 every
    partial sum rounded to bf16 (`segment_sum_bf16`), in f32 with f32's
    own adds. No atomics: the card repeats its bits and matches the plain
    version, `edge_order_sum_reference`, bit for bit. `gather_rows` is a
    gather onto edges whose gradient is this sum.
  * `padded_csr_agg`: for bounded-degree graphs (latent mesh and
    mesh->grid: <= 7) a dense [N, K] gather and masked sum, scatter-free
    and deterministic. In bf16 the sum runs in f32 and is rounded once, as
    XLA's reduction of the JAX package's padded_csr_agg.
  * `chunked_csr_agg`: the same sum in levels of padded CSR tables
    (`build_chunked_csr`): each node's edges in chunks of at most 16, then
    each node's chunks. Scatter-free and deterministic at any degree; the
    forecaster's graphs sum to high-degree nodes this way, in the
    aggregation (grid->mesh receivers) and in the fused edge update's
    backward (grid->mesh receivers, mesh->grid senders), in f32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from graph_weather_tpu_torch.ops._build import c_function

LAUNCHES = 0  # S in bf16 (csrc/segment_sum.cu)
F32_LAUNCHES = 0  # S in f32

_c_ptr, _c_i64, _c_int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [
    _c_ptr, _c_i64,  # edge rows [batch, E, F], batch stride
    _c_ptr, _c_ptr,  # offsets [N + 1], edge ids [E]
    _c_ptr,  # out [batch, N, F]
    _c_int, _c_int, _c_int,  # N, F, batch
    _c_ptr,  # cudaStream_t
]


def segment_sum_agg(
    edge_feats: torch.Tensor, receivers: torch.Tensor, n_receivers: int
) -> torch.Tensor:
    """Sum [..., E, F] edge features into [..., N, F] by receiver id."""
    shape = edge_feats.shape[:-2] + (n_receivers, edge_feats.shape[-1])
    out = torch.zeros(shape, dtype=edge_feats.dtype, device=edge_feats.device)
    return out.index_add_(-2, receivers, edge_feats)


def build_flat_csr(ids: np.ndarray, n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: the flat CSR of a sum of edges to `n_nodes` nodes by `ids`
    (one per edge, any order): offsets int32 [N + 1] and edge ids int32 [E],
    node n's edges at edge_ids[offsets[n] : offsets[n + 1]] in edge order."""
    ids = np.asarray(ids)
    offsets = np.zeros(n_nodes + 1, dtype=np.int32)
    np.cumsum(np.bincount(ids, minlength=n_nodes), out=offsets[1:])
    return offsets, np.argsort(ids, kind="stable").astype(np.int32)


def edge_order_sum_reference(
    edge_feats: torch.Tensor, offsets: torch.Tensor, edge_ids: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of S: at step j, the j-th edge of every node
    with more than j edges is added to its partial sum in the rows' dtype
    (so rounded to bf16 in bf16), over the padded table of the flat CSR.
    The number of steps, the longest run, is read from the offsets: on the
    host where the port runs it (CPU tensors), a host sync on the card."""
    starts = offsets[:-1].long()
    counts = offsets[1:].long() - starts
    max_degree = int(counts.max()) if counts.numel() else 0
    shape = edge_feats.shape[:-2] + (counts.shape[0], edge_feats.shape[-1])
    out = torch.zeros(shape, dtype=edge_feats.dtype, device=edge_feats.device)
    for j in range(max_degree):
        live = counts > j
        rows = edge_feats.index_select(-2, edge_ids[torch.where(live, starts + j, 0)].long())
        out = torch.where(live[:, None], out + rows, out)
    return out


_S_DTYPES = (torch.float32, torch.bfloat16)  # S's instantiations on the card


def _check_sum(name, edge_feats, offsets, edge_ids):
    if not edge_feats.is_floating_point() or (
        edge_feats.device.type != "cpu" and edge_feats.dtype not in _S_DTYPES
    ):
        raise TypeError(f"{name}: edge rows must be float32 or bfloat16 (any float on the CPU)")
    if offsets.dtype != torch.int32 or edge_ids.dtype != torch.int32:
        raise TypeError(f"{name}: offsets and edge ids must be int32")
    if offsets.dim() != 1 or offsets.shape[0] < 1 or edge_ids.shape != (edge_feats.shape[-2],):
        raise ValueError(f"{name}: offsets must be [N + 1] and edge ids [E], E the rows' edges")
    if edge_feats.dim() < 2 or any(t.device != edge_feats.device for t in (offsets, edge_ids)):
        raise ValueError(f"{name}: [..., E, F] rows, offsets and edge ids on one device")


def _segment_sum_cuda(edge_feats, offsets, edge_ids):
    """One S launch on [..., E, F] rows (bf16 or f32)."""
    lead, (n_edges, width) = edge_feats.shape[:-2], edge_feats.shape[-2:]
    rows = edge_feats.reshape(-1, n_edges, width)
    if rows.stride(-1) != 1 or (n_edges > 1 and rows.stride(-2) != width):
        rows = rows.contiguous()
    n_nodes, batch = offsets.shape[0] - 1, rows.shape[0]
    out = torch.empty((batch, n_nodes, width), dtype=rows.dtype, device=rows.device)
    if out.numel():
        bf16 = rows.dtype == torch.bfloat16
        entry = "gwt_segment_sum_bf16" if bf16 else "gwt_segment_sum_f32"
        with torch.cuda.device(rows.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = c_function("segment_sum", entry, _ARGTYPES)(
                rows.data_ptr(), rows.stride(0) if batch > 1 else 0,
                offsets.data_ptr(), edge_ids.data_ptr(), out.data_ptr(),
                n_nodes, width, batch, stream,
            )
        if err != 0:
            raise RuntimeError(f"edge_order_sum: CUDA kernel launch failed (cudaError {err})")
        global LAUNCHES, F32_LAUNCHES
        if bf16:
            LAUNCHES += 1
        else:
            F32_LAUNCHES += 1
    return out.reshape(lead + (n_nodes, width))


def _edge_order_sum(edge_feats, offsets, edge_ids):
    _check_sum("edge_order_sum", edge_feats, offsets, edge_ids)
    if edge_feats.device.type == "cpu":
        return edge_order_sum_reference(edge_feats, offsets, edge_ids)
    if edge_feats.device.type != "cuda":
        raise ValueError(f"edge_order_sum: no kernel for device {edge_feats.device}")
    return _segment_sum_cuda(edge_feats, offsets, edge_ids)


class _EdgeOrderSum(torch.autograd.Function):
    """S, whose gradient is a gather by each edge's node (exact: the
    transpose of XLA's segment_sum)."""

    @staticmethod
    def forward(ctx, edge_feats, offsets, edge_ids, nodes):
        ctx.save_for_backward(nodes)
        return _edge_order_sum(edge_feats, offsets, edge_ids)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (nodes,) = ctx.saved_tensors
        return grad.index_select(-2, nodes), None, None, None


def edge_order_sum(
    edge_feats: torch.Tensor,
    offsets: torch.Tensor,
    edge_ids: torch.Tensor,
    nodes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sum [..., E, F] edge rows to [..., N, F] nodes through the flat CSR
    (offsets int32 [N + 1], edge_ids int32 [E]; `build_flat_csr`), each
    node's edges one at a time in the CSR's order: in bf16 each partial sum
    rounded to bf16, in f32 (and, on the CPU, f64) in the rows' own adds.
    CPU tensors take the plain version, CUDA tensors the kernel S (never
    one for the other). Differentiable when `nodes` ([E], the node of each
    edge) is given: the gradient of an edge row is its node's; without
    `nodes`, rows that need a gradient raise on either device."""
    if torch.is_grad_enabled() and edge_feats.requires_grad:
        if nodes is None:
            raise ValueError("edge_order_sum: rows that need a gradient need `nodes`")
        return _EdgeOrderSum.apply(edge_feats, offsets, edge_ids, nodes)
    return _edge_order_sum(edge_feats, offsets, edge_ids)


def segment_sum_bf16(
    edge_feats: torch.Tensor,
    offsets: torch.Tensor,
    edge_ids: torch.Tensor,
    nodes: torch.Tensor | None = None,
) -> torch.Tensor:
    """`edge_order_sum` of bf16 rows (each partial sum rounded to bf16, as
    the JAX package's bf16 segment_sum); other dtypes raise."""
    if edge_feats.dtype != torch.bfloat16:
        raise TypeError("segment_sum_bf16: edge rows must be bfloat16")
    return edge_order_sum(edge_feats, offsets, edge_ids, nodes)


class _GatherRows(torch.autograd.Function):
    """x[..., index, :], whose gradient sums each row's edges in edge order
    through `csr` (S), where index_select's own gradient is index_add_
    (atomics on the card)."""

    @staticmethod
    def forward(ctx, x, index, offsets, edge_ids):
        ctx.csr = (offsets, edge_ids)
        return x.index_select(-2, index)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return _edge_order_sum(grad.contiguous(), *ctx.csr), None, None, None


def gather_rows(x: torch.Tensor, index: torch.Tensor, csr: tuple) -> torch.Tensor:
    """Rows `index` ([E] int32) of x [..., N, F] -> [..., E, F], a gather
    onto edges. Its gradient is the edge-order sum S over `csr`, the flat
    CSR of `index` (`build_flat_csr(index, N)`: a DeviceGraph's sender_csr
    or receiver_csr): each node's edges added in edge order, in a fixed
    order on the card, as the gradient of the JAX package's jnp.take adds
    them on the CPU."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, index, *csr)
    return x.index_select(-2, index)


def _table_sum(edge_feats: torch.Tensor, edge_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n, k = edge_ids.shape
    gathered = edge_feats.index_select(-2, edge_ids.reshape(-1))
    gathered = gathered.reshape(edge_feats.shape[:-2] + (n, k, edge_feats.shape[-1]))
    return (gathered * mask[..., None].to(edge_feats.dtype)).sum(dim=-2)


class _OwnedTableSum(torch.autograd.Function):
    """A table sum whose every edge sits in exactly one valid entry: the
    gradient of edge row e is the gradient row of the node that holds it,
    a gather by `owner`. index_select's own gradient would add every padded
    entry back with index_add_ (atomics on the card, and N x K rows)."""

    @staticmethod
    def forward(ctx, edge_feats, edge_ids, mask, owner):
        ctx.save_for_backward(owner)
        return _table_sum(edge_feats, edge_ids, mask)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (owner,) = ctx.saved_tensors
        return grad.index_select(-2, owner), None, None, None


def padded_csr_agg(
    edge_feats: torch.Tensor,
    edge_ids: torch.Tensor,
    mask: torch.Tensor,
    owner: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sum edge features via a padded CSR table.

    Args:
        edge_feats: [..., E, F].
        edge_ids: [N, K] int32 ids into the edge axis; padded entries may
            point anywhere (masked out).
        mask: [N, K] boolean validity.
        owner: optional [E] int64, the table row of each edge
            (`table_owner`), for a table that holds every edge exactly once:
            the gradient is then a gather.

    Returns:
        [..., N, F] aggregated features.
    """
    if owner is not None and torch.is_grad_enabled() and edge_feats.requires_grad:
        return _OwnedTableSum.apply(edge_feats, edge_ids, mask, owner)
    return _table_sum(edge_feats, edge_ids, mask)


def table_owner(edge_ids: np.ndarray, mask: np.ndarray, n_items: int) -> np.ndarray:
    """Host-side: the row of a padded CSR table that holds each of the
    n_items summed rows, int64 [n_items], for a table in which every row
    sits in exactly one valid entry (as in build_padded_csr's and
    build_chunked_csr's tables)."""
    ids = np.asarray(edge_ids)[np.asarray(mask)]
    if ids.size != n_items or np.bincount(ids, minlength=n_items).max(initial=0) > 1:
        raise ValueError("table_owner: every summed row must sit in exactly one valid entry")
    owner = np.zeros(n_items, dtype=np.int64)
    owner[ids] = np.nonzero(np.asarray(mask))[0]
    return owner


def build_padded_csr(receivers: np.ndarray, n_receivers: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: padded CSR (edge_ids [N, K], mask [N, K]) from node ids,
    one per edge (sorted receivers, or any order: each node's edges keep
    their order).

    K = max degree. Padded ids are 0 (always masked).
    """
    receivers = np.asarray(receivers)
    counts = np.bincount(receivers, minlength=n_receivers)
    k = int(counts.max()) if counts.size else 0
    edge_ids = np.zeros((n_receivers, k), dtype=np.int32)
    # Filling valid row-major slots with the edges in stable node order gives
    # each node its run of edge ids (for sorted ids, arange(E)).
    within = np.arange(k)[None, :] < counts[:, None]
    edge_ids[within] = np.argsort(receivers, kind="stable").astype(np.int32)
    return edge_ids, within


def build_chunked_csr(ids: np.ndarray, n_nodes: int, chunk: int = 16) -> list:
    """Host-side: the levels [(edge_ids, mask), ...] of a sum of edges to
    `n_nodes` nodes by `ids` (any order) through padded CSR tables at most
    `chunk` wide, but for the last. One level (build_padded_csr) when no
    node has more than `chunk` edges; else two: each node's edges in chunks
    of `chunk` ([n_chunks, chunk]), then each node's chunks ([N, max chunks])."""
    ids = np.asarray(ids)
    counts = np.bincount(ids, minlength=n_nodes)
    if counts.size == 0 or counts.max() <= chunk:
        return [build_padded_csr(ids, n_nodes)]
    order = np.argsort(ids, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    per_node = -(-counts // chunk)  # chunks of each node
    first_chunk = np.concatenate([[0], np.cumsum(per_node)[:-1]])
    node = ids[order]
    pos = np.arange(ids.shape[0]) - starts[node]  # position in the node's run
    rows = first_chunk[node] + pos // chunk
    edge_ids = np.zeros((int(per_node.sum()), chunk), dtype=np.int32)
    mask = np.zeros(edge_ids.shape, dtype=bool)
    edge_ids[rows, pos % chunk] = order
    mask[rows, pos % chunk] = True
    chunk_node = np.repeat(np.arange(n_nodes), per_node)
    return [(edge_ids, mask), build_padded_csr(chunk_node, n_nodes)]


def chunked_csr_agg(edge_feats: torch.Tensor, levels) -> torch.Tensor:
    """Sum [..., E, F] edge features to [..., N, F] through the levels of
    `build_chunked_csr` (as tensors, each (edge_ids, mask) or (edge_ids,
    mask, owner)), in a fixed order."""
    for level in levels:
        edge_feats = padded_csr_agg(edge_feats, *level)
    return edge_feats
