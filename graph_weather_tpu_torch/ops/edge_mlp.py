"""Fused MeshGraphNet edge update: the port of the Pallas kernel K1.

Computes, for every edge (s, r) of a graph and every batch entry:

    h0 = relu(x_src[s] @ Ws + x_dst[r] @ Wd + e @ We + b0)
    h1 = relu(h0 @ W1 + b1)
    h2 = h1 @ W2 + b2
    e' = LayerNorm(h2) * gamma + beta + e          (residual, eps 1e-5)

with [Ws; Wd; We] = w0, the fused first-layer kernel of the flax
TorchLinear_0 ([F_src + F_dst + F_e, H]). It replaces
graph_weather_tpu/ops/pallas/edge_mlp.py (`fused_edge_mlp`, kernel body
`_kernel`), which never compiled for the TPU because Mosaic cannot gather
rows inside a kernel; the CUDA kernel in csrc/edge_mlp.cu gathers its own
rows. Beyond the TPU kernel it takes a batch axis ([B, N, F] nodes, and e
either [E, Fe] broadcast over the batch or [B, E, Fe]) and x_dst=None, which
skips the Wd term for destination nodes known to be zero.

`fused_edge_mlp` runs the plain PyTorch twin `fused_edge_mlp_reference` for
CPU tensors and launches the CUDA kernel for CUDA tensors; it never falls
back from one to the other. `LAUNCHES` counts kernel launches. The model's
edge blocks run the kernel's partial-product mode instead, with its
backward (ops/fused_mlp.py); this raw mode serves callers that hold only
node rows, under torch.no_grad() on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from graph_weather_tpu_torch.ops._build import c_function

LAUNCHES = 0
MAX_WIDTH = 256  # widest H and Fe the kernel's tiles hold

_c_ptr, _c_i64, _c_int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [
    _c_ptr, _c_ptr,  # senders, receivers
    _c_ptr, _c_i64, _c_int,  # x_src, batch stride, F_src
    _c_ptr, _c_i64, _c_int,  # x_dst (may be NULL), batch stride, F_dst
    _c_ptr, _c_i64, _c_int,  # e, batch stride, F_e
    _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # w0 b0 w1 b1 w2 b2
    _c_ptr, _c_ptr,  # gamma, beta (NULL: no LayerNorm)
    _c_ptr,  # out
    _c_int, _c_int, _c_int,  # n_edges, batch, hidden
    _c_ptr,  # cudaStream_t
]


def fused_edge_mlp_reference(
    senders: torch.Tensor,
    receivers: torch.Tensor,
    x_src: torch.Tensor,
    x_dst: Optional[torch.Tensor],
    e: torch.Tensor,
    w0: torch.Tensor,
    b0: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gamma: Optional[torch.Tensor] = None,
    beta: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in the factorized form of the
    JAX package's EdgeBlock: node partial products are taken per node and
    then gathered, which is the same sum in another order."""
    f_s, f_e = x_src.shape[-1], e.shape[-1]
    f_d = w0.shape[0] - f_s - f_e
    h = (x_src @ w0[:f_s]).index_select(-2, senders)
    if x_dst is not None:
        h = h + (x_dst @ w0[f_s : f_s + f_d]).index_select(-2, receivers)
    h = torch.relu(h + e @ w0[f_s + f_d :] + b0)
    h = torch.relu(h @ w1 + b1)
    h = h @ w2 + b2
    if gamma is not None:
        h = F.layer_norm(h, (f_e,), gamma, beta, eps=1e-5)
    return h + e


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Each [rows, width] matrix is dense row-major; any batch stride."""
    return t.stride(-1) == 1 and (t.shape[-2] <= 1 or t.stride(-2) == t.shape[-1])


def _check(senders, receivers, x_src, x_dst, e, w0, b0, w1, b1, w2, b2, gamma, beta):
    weights = [w0, b0, w1, b1, w2, b2] + [t for t in (gamma, beta) if t is not None]
    features = [x_src, e] + ([x_dst] if x_dst is not None else [])
    tensors = [senders, receivers] + features + weights
    device = x_src.device
    if any(t.device != device for t in tensors):
        raise ValueError("fused_edge_mlp: all tensors must be on one device")
    if senders.dtype != torch.int32 or receivers.dtype != torch.int32:
        raise TypeError("fused_edge_mlp: senders/receivers must be int32")
    if any(t.dtype != torch.float32 for t in tensors[2:]):
        raise TypeError("fused_edge_mlp: features and weights must be float32")
    if (gamma is None) != (beta is None):
        raise ValueError("fused_edge_mlp: pass both gamma and beta, or neither")
    n_edges = senders.shape[0]
    if senders.shape != (n_edges,) or receivers.shape != (n_edges,):
        raise ValueError("fused_edge_mlp: senders/receivers must both be [E]")
    if x_src.dim() not in (2, 3) or e.dim() not in (2, 3):
        raise ValueError("fused_edge_mlp: x_src and e must be [N, F] or [B, N, F]")
    batched = x_src.dim() == 3
    batch = x_src.shape[0] if batched else 1
    if x_dst is not None and x_dst.dim() != x_src.dim():
        raise ValueError("fused_edge_mlp: x_dst must have x_src's rank")
    if e.dim() == 3 and not batched:
        raise ValueError("fused_edge_mlp: batched e needs batched node features")
    for t in (x_dst, e):
        if t is not None and t.dim() == 3 and t.shape[0] != batch:
            raise ValueError("fused_edge_mlp: batch sizes differ")
    if e.shape[-2] != n_edges:
        raise ValueError(f"fused_edge_mlp: e has {e.shape[-2]} edges, indices {n_edges}")
    f_s, f_e = x_src.shape[-1], e.shape[-1]
    hidden = w1.shape[0]
    f_d = w0.shape[0] - f_s - f_e
    if x_dst is not None and x_dst.shape[-1] != f_d:
        raise ValueError("fused_edge_mlp: x_dst width does not match w0")
    if (
        w0.dim() != 2
        or f_d < 0
        or w0.shape[1] != hidden
        or w1.shape != (hidden, hidden)
        or w2.shape != (hidden, f_e)
        or b0.shape != (hidden,)
        or b1.shape != (hidden,)
        or b2.shape != (f_e,)
        or (gamma is not None and (gamma.shape != (f_e,) or beta.shape != (f_e,)))
    ):
        raise ValueError(
            "fused_edge_mlp: weights must be w0 [F_src+F_dst+F_e, H], w1 [H, H], "
            "w2 [H, F_e], biases [H], [H], [F_e], gamma/beta [F_e]"
        )
    if not 0 < hidden <= MAX_WIDTH or not 0 < f_e <= MAX_WIDTH or f_s <= 0:
        raise ValueError(f"fused_edge_mlp: widths must be in 1..{MAX_WIDTH}")
    if not all(_rows_contiguous(t) for t in features):
        raise ValueError("fused_edge_mlp: node and edge rows must be dense row-major")
    if not all(t.is_contiguous() for t in weights):
        raise ValueError("fused_edge_mlp: weights must be contiguous")
    return batched, batch, n_edges, f_s, f_d, f_e, hidden


def _batch_stride(t: Optional[torch.Tensor]) -> int:
    return t.stride(0) if t is not None and t.dim() == 3 else 0


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def fused_edge_mlp(
    senders: torch.Tensor,
    receivers: torch.Tensor,
    x_src: torch.Tensor,
    x_dst: Optional[torch.Tensor],
    e: torch.Tensor,
    w0: torch.Tensor,
    b0: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gamma: Optional[torch.Tensor] = None,
    beta: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """e' = LN(MLP([x_src[s], x_dst[r], e])) + e, batched or not.

    Shapes: senders/receivers int32 [E]; x_src [N_src, F] or [B, N_src, F];
    x_dst likewise or None; e [E, Fe] or [B, E, Fe]; weights as in the
    module docstring; gamma/beta None for no LayerNorm. Returns [E, Fe]
    for unbatched inputs, else [B, E, Fe].
    """
    args = (senders, receivers, x_src, x_dst, e, w0, b0, w1, b1, w2, b2, gamma, beta)
    batched, batch, n_edges, f_s, f_d, f_e, hidden = _check(*args)
    if x_src.device.type == "cpu":
        return fused_edge_mlp_reference(*args)
    if x_src.device.type != "cuda":
        raise ValueError(f"fused_edge_mlp: no kernel for device {x_src.device}")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in args
    ):
        raise NotImplementedError(
            "fused_edge_mlp (raw node rows) has no backward on CUDA; run it under "
            "torch.no_grad(), or train through ops/fused_mlp.fused_edge_update "
            "(per-node partial products, K2 with its backward K2b), as nn.EdgeBlock does."
        )
    out = torch.empty((batch, n_edges, f_e), dtype=torch.float32, device=x_src.device)
    if out.numel() == 0:  # nothing to launch
        return out if batched else out[0]
    with torch.cuda.device(x_src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            senders.data_ptr(), receivers.data_ptr(),
            x_src.data_ptr(), _batch_stride(x_src), f_s,
            _ptr(x_dst), _batch_stride(x_dst), f_d,
            e.data_ptr(), _batch_stride(e), f_e,
            w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), _ptr(gamma), _ptr(beta),
            out.data_ptr(), n_edges, batch, hidden, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_edge_mlp: CUDA kernel launch failed (cudaError {err})")
    global LAUNCHES
    LAUNCHES += 1
    return out if batched else out[0]


def _kernel_fn():
    return c_function("edge_mlp", "gwt_edge_mlp_forward", _ARGTYPES)
