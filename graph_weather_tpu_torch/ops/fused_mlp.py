"""Fused MeshGraphNet edge update from per-node partial products, and its
gradient: the port of the Pallas kernel K2 and its backward K2b.

For every edge (s, r) of a graph and every batch entry:

    h0 = relu(p_src[s] + p_dst[r] + e @ We + b0)
    h1 = relu(h0 @ W1 + b1)
    h2 = h1 @ W2 + b2
    e' = LayerNorm(h2) * gamma + beta + e          (residual, eps 1e-5)

where p_src = x_src @ Ws and p_dst = x_dst @ Wd are the first layer's node
terms, taken once per node by the caller (N << E), and [Ws; Wd; We] is the
flax TorchLinear_0 kernel. It replaces graph_weather_tpu/ops/pallas/fused_mlp.py
(`fused_edge_update`, `_fused_padded`, kernel body `_kernel`), whose inputs
are the same partials already gathered per edge by XLA: with
senders = receivers = arange(E) this is that function. The CUDA forward is
the partial-product mode of K1 (csrc/edge_mlp.cu), which gathers the partial
rows itself; the backward K2b (csrc/fused_mlp_bwd.cu) recomputes the chain
per edge tile and writes what the plain sums below need.

Shapes: senders/receivers int32 [E] (receivers sorted, as every graph of the
port); p_src [N_src, H] or [B, N_src, H]; p_dst likewise, or None when the
destination nodes are known to be zero (the decoder's dst_is_zero); e
[E, Fe] (broadcast over the batch) or [B, E, Fe]; gamma/beta None for no
LayerNorm. Unbatched operands broadcast over the batch with a batch stride
of 0 and their gradients sum over it.

`fused_edge_update` is differentiable in every tensor but the indices. CPU
tensors take the plain PyTorch versions, `fused_edge_update_reference` and
`fused_edge_update_backward_reference` (written out step by step, not
autograd through the forward); CUDA tensors launch the kernels or raise,
never falling back. `LAUNCHES` counts K2 launches, `BACKWARD_LAUNCHES` K2b's.

What stays plain PyTorch, as the JAX package leaves it to XLA: the weight
gradients h1^T dh2, h0^T dh1 and e^T dh0 (torch.matmul over the B E rows),
the per-tile column sums of K2b added in a fixed order, and the sums of dh0
to the nodes. The caller gives those sums as levels of padded CSR tables,
`sender_sum` and `receiver_sum` (((edge_ids, mask), ...) as
`ops.scatter.build_chunked_csr` builds them, and as DeviceGraph carries them
under from_bundle(..., edge_sums=True)): scatter-free, so the whole backward
is deterministic on the card, since K2b too adds in a fixed order and uses no
atomics.

The kernels take float32, or bfloat16 for the bf16 compute policy
(GraphWeatherForecaster.forward_fn(compute_dtype=torch.bfloat16)): every
operand but the indices bf16, the output and the gradients bf16, rounded
where XLA rounds the JAX package's EdgeBlock in bf16 (the plain versions
spell the points out: each product and add rounded; the last bias add and
the LayerNorm in f32, rounded once, as flax's LayerNorm of a bf16 input; its
backward as nn.bf16.layer_norm_backward). The bf16 sums of dh0 to the nodes
are XLA's gradient of jnp.take, in edge order with every partial sum
rounded: the kernel S (ops.scatter.segment_sum_bf16) over the flat CSRs
`sender_csr` and `receiver_csr` ((offsets, edge_ids), as DeviceGraph
carries them), which the bf16 calls require. `BF16_LAUNCHES` and
`BF16_BACKWARD_LAUNCHES` count the bf16 kernels. On the CPU the plain
versions also take float64 (every operand but the indices), for reference
gradients.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from graph_weather_tpu_torch.nn.bf16 import f32_sums, layer_norm_backward
from graph_weather_tpu_torch.ops._build import c_function
from graph_weather_tpu_torch.ops.edge_mlp import _batch_stride, _ptr, _rows_contiguous
from graph_weather_tpu_torch.ops.scatter import (
    chunked_csr_agg,
    segment_sum_bf16,
    edge_order_sum_reference,
)

LAUNCHES = 0  # K2 (csrc/edge_mlp.cu, partial-product mode)
BACKWARD_LAUNCHES = 0  # K2b (csrc/fused_mlp_bwd.cu)
BF16_LAUNCHES = 0  # K2 in bf16
BF16_BACKWARD_LAUNCHES = 0  # K2b in bf16
MAX_WIDTH = 256  # widest H and Fe the kernels' tiles hold
TILE_EDGES = 64  # edges per CUDA block (TE in csrc/edge_tile.cuh)
_SLOTS = ("b0", "b1", "b2", "gamma", "beta")  # K2b's per-tile column sums

_c_ptr, _c_i64, _c_int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_FWD_ARGTYPES = [
    _c_ptr, _c_ptr,  # senders, receivers
    _c_ptr, _c_i64,  # p_src, batch stride
    _c_ptr, _c_i64,  # p_dst (may be NULL), batch stride
    _c_ptr, _c_i64, _c_int,  # e, batch stride, F_e
    _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # we b0 w1 b1 w2 b2
    _c_ptr, _c_ptr,  # gamma, beta (NULL: no LayerNorm)
    _c_ptr,  # out
    _c_int, _c_int, _c_int,  # n_edges, batch, hidden
    _c_ptr,  # cudaStream_t
]
_BWD_ARGTYPES = [
    _c_ptr, _c_ptr,  # senders, receivers
    _c_ptr, _c_i64, _c_ptr, _c_i64,  # p_src, stride, p_dst (may be NULL), stride
    _c_ptr, _c_i64, _c_ptr,  # e, batch stride, dout
    _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # we b0 w1 b1 w2 b2
    _c_ptr,  # gamma (NULL: no LayerNorm)
    _c_ptr, _c_ptr, _c_ptr,  # w2^T, w1^T, we^T
    _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # h0 h1 dh2 dh1 dh0 de
    _c_ptr,  # colsum
    _c_int, _c_int, _c_int, _c_int,  # n_edges, batch, f_e, hidden
    _c_ptr,  # cudaStream_t
]

Levels = tuple  # ((edge_ids [N_l, K_l], mask [N_l, K_l]), ...)
Csr = tuple  # (offsets int32 [N + 1], edge_ids int32 [E]): ops.scatter.build_flat_csr
_ENTRIES = {  # (forward, backward) C entries by dtype
    torch.float32: ("gwt_edge_update_forward", "gwt_fused_mlp_backward"),
    torch.bfloat16: ("gwt_edge_update_forward_bf16", "gwt_fused_mlp_backward_bf16"),
}


def fused_edge_update_activations(senders, receivers, p_src, p_dst, e, we, b0, w1, b1):
    """The plain forward's hidden activations (h0, h1), [..., E, H]."""
    h0 = p_src.index_select(-2, senders)
    if p_dst is not None:
        h0 = h0 + p_dst.index_select(-2, receivers)
    h0 = torch.relu(h0 + e @ we + b0)
    return h0, torch.relu(h0 @ w1 + b1)


def fused_edge_update_reference(
    senders, receivers, p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma=None, beta=None
) -> torch.Tensor:
    """Plain PyTorch version of K2: gather the partial rows, then the chain
    (in bf16 each operation rounded, see the module docstring)."""
    _, h1 = fused_edge_update_activations(senders, receivers, p_src, p_dst, e, we, b0, w1, b1)
    if h1.dtype == torch.bfloat16 and gamma is not None:
        # The last bias add, whose only use is the LayerNorm's f32 statistics,
        # in f32; the LayerNorm's statistics and affine in f32, rounded once.
        h = (h1 @ w2).float() + b2.float()
        h = F.layer_norm(h, (h.shape[-1],), gamma.float(), beta.float(), eps=1e-5).to(h1.dtype)
    else:
        h = h1 @ w2 + b2
        if gamma is not None:
            h = F.layer_norm(h, (h.shape[-1],), gamma, beta, eps=1e-5)
    return h + e


def _batch_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the leading batch axis (a view of the one entry at B = 1)."""
    return t[0] if t.shape[0] == 1 else t.sum(0)


def _unbroadcast(grad: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Sum a [B, ...] gradient over the batch for an operand that had none."""
    return _batch_sum(grad) if like.dim() < grad.dim() else grad


def _param_grads(p_src, p_dst, e, dh0, de, sums, plain=False):
    """The node, edge and weight-slice gradients from dh0 [B, E, H] and de
    [B, E, Fe]: the sums to the nodes, and e^T dh0. `sums`: (sender_sum,
    receiver_sum, sender_csr, receiver_csr), the tables of f32 and the flat
    CSRs of bf16 (S, in edge order; its plain version when `plain`)."""
    sender_sum, receiver_sum, sender_csr, receiver_csr = sums
    bf16 = dh0.dtype == torch.bfloat16
    edge_order_sum = edge_order_sum_reference if plain else segment_sum_bf16

    def node_sum(levels, csr):
        return edge_order_sum(dh0, *csr) if bf16 else chunked_csr_agg(dh0, levels)

    dp_src = _unbroadcast(node_sum(sender_sum, sender_csr), p_src)
    dp_dst = None
    if p_dst is not None:
        dp_dst = _unbroadcast(node_sum(receiver_sum, receiver_csr), p_dst)
    if e.dim() == 3:
        dwe = e.reshape(-1, e.shape[-1]).t() @ dh0.reshape(-1, dh0.shape[-1])
    elif bf16 and dh0.shape[0] > 1:  # one product over the B E rows, rounded once
        dwe = e.expand(dh0.shape[:-1] + e.shape[-1:]).reshape(-1, e.shape[-1]).t() @ (
            dh0.reshape(-1, dh0.shape[-1]))
    else:
        dwe = e.t() @ _batch_sum(dh0)
    return dp_src, dp_dst, _unbroadcast(de, e), dwe


def fused_edge_update_backward_reference(
    senders, receivers, p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma, beta, dout,
    sender_sum: Levels, receiver_sum: Levels, activations=None,
    sender_csr: Optional[Csr] = None, receiver_csr: Optional[Csr] = None,
):
    """Plain PyTorch version of the backward, written out step by step: the
    recomputed chain, the LayerNorm backward, the ReLU masks, the three
    data-gradient products, the weight and bias sums and the sums to the
    nodes (through the tables `sender_sum` and `receiver_sum`, see the
    module docstring; in bf16 through the flat CSRs `sender_csr` and
    `receiver_csr`). dout is [B, E, Fe] (or [E, Fe] when every operand is
    unbatched).
    Returns the gradients of (p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma,
    beta), None for an operand that is None.

    `activations`: (h0, h1) [B, E, H] to use instead of recomputing them. A
    pre-activation within rounding of 0 can fall on either side of a ReLU in
    two f32 computations of the same forward, and the gradient is not
    continuous there; given the kernel's own h0 and h1 (launch_backward),
    this is the gradient at the kernel's ReLU masks."""
    if dout.dim() == 2:  # nothing batched: the gradients come back unbatched
        dout = dout[None]
    if activations is None:
        activations = fused_edge_update_activations(
            senders, receivers, p_src, p_dst, e, we, b0, w1, b1
        )
    shape = dout.shape[:-1] + (w1.shape[0],)
    h0, h1 = (h.expand(shape) for h in activations)
    dgamma = dbeta = None
    if gamma is not None and dout.dtype == torch.bfloat16:
        # flax's LayerNorm of the f32 bias add, differentiated as XLA does.
        dh2, dgamma, dbeta = layer_norm_backward((h1 @ w2).float() + b2.float(), gamma, dout, 1e-5)
        dh2, dgamma, dbeta = dh2.to(dout.dtype), dgamma.to(dout.dtype), dbeta.to(dout.dtype)
    elif gamma is not None:
        h2 = h1 @ w2 + b2
        centred = h2 - h2.mean(-1, keepdim=True)
        rstd = torch.rsqrt((centred * centred).mean(-1, keepdim=True) + 1e-5)
        normed = centred * rstd
        g = dout * gamma
        dh2 = rstd * (g - g.mean(-1, keepdim=True) - normed * (g * normed).mean(-1, keepdim=True))
        dgamma = (dout * normed).sum((0, 1))
        dbeta = dout.sum((0, 1))
    else:
        dh2 = dout
    dh1 = (dh2 @ w2.t()) * (h1 > 0)
    dh0 = (dh1 @ w1.t()) * (h0 > 0)
    de = dout + dh0 @ we.t()

    def rows(t):
        return t.reshape(-1, t.shape[-1])

    dw2 = rows(h1).t() @ rows(dh2)
    dw1 = rows(h0).t() @ rows(dh1)
    sums = (sender_sum, receiver_sum, sender_csr, receiver_csr)
    dp_src, dp_dst, de, dwe = _param_grads(p_src, p_dst, e, dh0, de, sums, plain=True)
    return (
        dp_src, dp_dst, de, dwe, dh0.sum((0, 1)), dw1, dh1.sum((0, 1)), dw2,
        dh2.sum((0, 1)), dgamma, dbeta,
    )


def _check(senders, receivers, p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma, beta):
    """Validates the operands; returns (batch or None when nothing is
    batched, n_edges, f_e, hidden)."""
    name = "fused_edge_update"
    weights = [we, b0, w1, b1, w2, b2] + [t for t in (gamma, beta) if t is not None]
    rows = [p_src, e] + ([p_dst] if p_dst is not None else [])
    tensors = [senders, receivers] + rows + weights
    if any(t.device != p_src.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if senders.dtype != torch.int32 or receivers.dtype != torch.int32:
        raise TypeError(f"{name}: senders/receivers must be int32")
    dtypes = {t.dtype for t in tensors[2:]}
    allowed = (torch.float32, torch.bfloat16)
    if p_src.device.type == "cpu":
        allowed += (torch.float64,)
    if len(dtypes) != 1 or dtypes.pop() not in allowed:
        raise TypeError(
            f"{name}: partials, edges and weights must be all float32 or all bfloat16 (or all "
            "float64 on the CPU)"
        )
    if (gamma is None) != (beta is None):
        raise ValueError(f"{name}: pass both gamma and beta, or neither")
    n_edges = senders.shape[0]
    if senders.shape != (n_edges,) or receivers.shape != (n_edges,):
        raise ValueError(f"{name}: senders/receivers must both be [E]")
    if any(t.dim() not in (2, 3) for t in rows):
        raise ValueError(f"{name}: p_src, p_dst and e must be [N, F] or [B, N, F]")
    batches = {t.shape[0] for t in rows if t.dim() == 3}
    if len(batches) > 1:
        raise ValueError(f"{name}: batch sizes differ")
    if e.shape[-2] != n_edges:
        raise ValueError(f"{name}: e has {e.shape[-2]} edges, indices {n_edges}")
    f_e, hidden = e.shape[-1], w1.shape[0]
    if any(t.shape[-1] != hidden for t in rows[:1] + rows[2:]):
        raise ValueError(f"{name}: p_src/p_dst width must be the hidden width {hidden}")
    if (
        we.shape != (f_e, hidden)
        or w1.shape != (hidden, hidden)
        or w2.shape != (hidden, f_e)
        or b0.shape != (hidden,)
        or b1.shape != (hidden,)
        or b2.shape != (f_e,)
        or (gamma is not None and (gamma.shape != (f_e,) or beta.shape != (f_e,)))
    ):
        raise ValueError(
            f"{name}: weights must be we [F_e, H], w1 [H, H], w2 [H, F_e], biases "
            "[H], [H], [F_e], gamma/beta [F_e]"
        )
    if not 0 < hidden <= MAX_WIDTH or not 0 < f_e <= MAX_WIDTH:
        raise ValueError(f"{name}: widths must be in 1..{MAX_WIDTH}")
    if not all(_rows_contiguous(t) for t in rows):
        raise ValueError(f"{name}: partial and edge rows must be dense row-major")
    if not all(t.is_contiguous() for t in weights):
        raise ValueError(f"{name}: weights must be contiguous")
    return (batches.pop() if batches else None), n_edges, f_e, hidden


def _forward_cuda(senders, receivers, p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma, beta):
    """One K2 launch; returns [B, E, Fe], or [E, Fe] when nothing is batched."""
    batch, n_edges, f_e, hidden = _check(
        senders, receivers, p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma, beta
    )
    out = torch.empty((batch or 1, n_edges, f_e), dtype=e.dtype, device=p_src.device)
    if out.numel() == 0:  # nothing to launch
        return out if batch else out[0]
    with torch.cuda.device(p_src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = c_function("edge_mlp", _ENTRIES[e.dtype][0], _FWD_ARGTYPES)(
            senders.data_ptr(), receivers.data_ptr(),
            p_src.data_ptr(), _batch_stride(p_src),
            _ptr(p_dst), _batch_stride(p_dst),
            e.data_ptr(), _batch_stride(e), f_e,
            we.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), _ptr(gamma), _ptr(beta),
            out.data_ptr(), n_edges, batch or 1, hidden, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_edge_update: CUDA kernel launch failed (cudaError {err})")
    global LAUNCHES, BF16_LAUNCHES
    if e.dtype == torch.bfloat16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out if batch else out[0]


def launch_backward(senders, receivers, p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma, dout):
    """One K2b launch on [B, E, Fe] dout. Returns (h0, h1, dh2, dh1, dh0, de)
    as [B, E, width] in dout's dtype and the per-tile column sums (f32), a
    dict of [B * n_tiles, width] tensors under b0, b1, b2, gamma, beta (the
    last two only with the LayerNorm)."""
    batch, n_edges, f_e = dout.shape
    hidden = w1.shape[0]
    dev = dout.device

    def buf(width):
        return torch.empty((batch, n_edges, width), dtype=dout.dtype, device=dev)

    h0, h1, dh1, dh0 = buf(hidden), buf(hidden), buf(hidden), buf(hidden)
    dh2, de = buf(f_e), buf(f_e)
    n_tiles = batch * -(-n_edges // TILE_EDGES)
    colsum = torch.empty((len(_SLOTS), n_tiles, MAX_WIDTH), dtype=torch.float32, device=dev)
    transposed = [w.t().contiguous() for w in (w2, w1, we)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = c_function("fused_mlp_bwd", _ENTRIES[dout.dtype][1], _BWD_ARGTYPES)(
            senders.data_ptr(), receivers.data_ptr(),
            p_src.data_ptr(), _batch_stride(p_src), _ptr(p_dst), _batch_stride(p_dst),
            e.data_ptr(), _batch_stride(e), dout.data_ptr(),
            we.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), _ptr(gamma),
            *(t.data_ptr() for t in transposed),
            h0.data_ptr(), h1.data_ptr(), dh2.data_ptr(), dh1.data_ptr(), dh0.data_ptr(),
            de.data_ptr(), colsum.data_ptr(), n_edges, batch, f_e, hidden, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_edge_update backward: CUDA kernel launch failed (cudaError {err})")
    global BACKWARD_LAUNCHES, BF16_BACKWARD_LAUNCHES
    if dout.dtype == torch.bfloat16:
        BF16_BACKWARD_LAUNCHES += 1
    else:
        BACKWARD_LAUNCHES += 1
    widths = dict(b0=hidden, b1=hidden, b2=f_e, gamma=f_e, beta=f_e)
    slots = _SLOTS if gamma is not None else _SLOTS[:3]
    sums = {k: colsum[_SLOTS.index(k), :, : widths[k]] for k in slots}
    return (h0, h1, dh2, dh1, dh0, de), sums


def _backward_cuda(senders, receivers, p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma, beta,
                   dout, sender_sum, receiver_sum, sender_csr=None, receiver_csr=None):
    """K2b, then the plain products and sums; the gradients as the reference
    returns them."""
    dout = (dout[None] if dout.dim() == 2 else dout).contiguous()
    if dout.shape[1] == 0:  # an empty graph: nothing to launch
        zero = [torch.zeros_like(t) if t is not None else None
                for t in (p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma, beta)]
        return tuple(zero)
    (h0, h1, dh2, dh1, dh0, de), tiles = launch_backward(
        senders, receivers, p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma, dout
    )

    def rows(t):
        return t.reshape(-1, t.shape[-1])

    with f32_sums():
        dw2 = rows(h1).t() @ rows(dh2)
        dw1 = rows(h0).t() @ rows(dh1)
        del h0, h1, dh2, dh1
        # The per-tile sums (f32), added in a fixed order (no atomics).
        total = {k: v.sum(0).to(dout.dtype) for k, v in tiles.items()}
        sums = (sender_sum, receiver_sum, sender_csr, receiver_csr)
        dp_src, dp_dst, de, dwe = _param_grads(p_src, p_dst, e, dh0, de, sums)
    return (
        dp_src, dp_dst, de, dwe, total["b0"], dw1, total["b1"], dw2, total["b2"],
        total.get("gamma"), total.get("beta"),
    )


class _FusedEdgeUpdate(torch.autograd.Function):
    """K2 forward, K2b backward (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, senders, receivers, p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma, beta,
                sums):
        args = (senders, receivers, p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma, beta)
        if p_src.device.type == "cpu":
            out = fused_edge_update_reference(*args)
        else:
            out = _forward_cuda(*args)
        ctx.save_for_backward(*args)
        ctx.sums = sums
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        args = ctx.saved_tensors
        sender_sum, receiver_sum, sender_csr, receiver_csr = ctx.sums
        tables = dict(sender_csr=sender_csr, receiver_csr=receiver_csr)
        if args[2].device.type == "cpu":
            grads = fused_edge_update_backward_reference(
                *args, dout, sender_sum, receiver_sum, **tables)
        else:
            grads = _backward_cuda(*args, dout, sender_sum, receiver_sum, **tables)
        return (None, None, *grads, None)


def fused_edge_update(
    senders: torch.Tensor,
    receivers: torch.Tensor,
    p_src: torch.Tensor,
    p_dst: Optional[torch.Tensor],
    e: torch.Tensor,
    we: torch.Tensor,
    b0: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gamma: Optional[torch.Tensor] = None,
    beta: Optional[torch.Tensor] = None,
    *,
    sender_sum: Levels,
    receiver_sum: Levels,
    sender_csr: Optional[Csr] = None,
    receiver_csr: Optional[Csr] = None,
) -> torch.Tensor:
    """e' = LN(MLP chain from the gathered partials) + e (see the module
    docstring). Returns [B, E, Fe], or [E, Fe] when no operand is batched.
    Differentiable; the backward sums to the nodes through `sender_sum` and
    `receiver_sum`, in bf16 through `sender_csr` and `receiver_csr` (see the
    module docstring)."""
    args = (senders, receivers, p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma, beta)
    _check(*args)
    if sender_sum is None or receiver_sum is None:
        raise ValueError(
            "fused_edge_update: sender_sum/receiver_sum are required (ops.scatter."
            "build_chunked_csr, or a DeviceGraph built with edge_sums=True)"
        )
    if e.dtype == torch.bfloat16 and (sender_csr is None or receiver_csr is None):
        raise ValueError(
            "fused_edge_update: bf16 needs sender_csr/receiver_csr (ops.scatter.build_flat_csr, "
            "or a DeviceGraph's)"
        )
    if p_src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_edge_update: no kernel for device {p_src.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        sums = (sender_sum, receiver_sum, sender_csr, receiver_csr)
        return _FusedEdgeUpdate.apply(*args, sums)
    if p_src.device.type == "cpu":
        return fused_edge_update_reference(*args)
    return _forward_cuda(*args)
