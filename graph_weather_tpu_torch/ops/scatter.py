"""Edge->node aggregation primitives (port of graph_weather_tpu/ops/scatter.py).

Both strategies are XLA in the JAX package, so they are plain PyTorch here:

  * `segment_sum_agg`: `index_add_` over the receiver ids. Works for any
    degree distribution (grid->mesh cells receive up to 720 grid points at
    the poles of a 1° grid). On CUDA the sum uses atomics, so its order,
    and the last bits of the result, change from run to run.
  * `padded_csr_agg`: for bounded-degree graphs (latent mesh and
    mesh->grid: <= 7) a dense [N, K] gather and masked sum, scatter-free
    and deterministic.
  * `chunked_csr_agg`: the same sum in levels of padded CSR tables
    (`build_chunked_csr`): each node's edges in chunks of at most 16, then
    each node's chunks. Scatter-free and deterministic at any degree; the
    forecaster's graphs sum to high-degree nodes this way, in the
    aggregation (grid->mesh receivers) and in the fused edge update's
    backward (grid->mesh receivers, mesh->grid senders).
"""

from __future__ import annotations

import numpy as np
import torch


def segment_sum_agg(
    edge_feats: torch.Tensor, receivers: torch.Tensor, n_receivers: int
) -> torch.Tensor:
    """Sum [..., E, F] edge features into [..., N, F] by receiver id."""
    shape = edge_feats.shape[:-2] + (n_receivers, edge_feats.shape[-1])
    out = torch.zeros(shape, dtype=edge_feats.dtype, device=edge_feats.device)
    return out.index_add_(-2, receivers, edge_feats)


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
