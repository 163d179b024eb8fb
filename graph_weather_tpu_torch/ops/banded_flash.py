"""Banded flash attention and its gradient: the port of the Pallas kernels
K4a (forward) and K4b (backward), graph_weather_tpu/ops/pallas/
banded_flash.py (`banded_flash_attention`: `_flash_impl`, `_flash_bwd_impl`).

The layout is that of ops/banded_attention.py: receiver block b (rows
b * block .. b * block + block - 1) attends to window slot j, key row
s = b * block + j - w, through band_masks[b] ([nb, block, block + 2w] int8);
key rows outside [0, N) are zero rows. For batch entry i, head g and
receiver r of block b:

    out[i, r, g] = sum_j softmax_j(q.k[s] / sqrt(c) + bias) v[s]

with bias 0 on an edge and -1e30 off it, the running max starting at -1e28,
and the output divided by max(l, 1e-30): rows without a neighbour, and
padded rows past N, come out exactly 0. q, k and v are [N, h, c] or
[B, N, h, c] over one node set; the batch shares the masks.

csrc/banded_flash.cu (K4a) runs on the card in f32 on the CUDA cores,
skipping key tiles without an edge; when autograd needs gradients it also
writes the log-sum-exp lse [B, nb * block, h]. csrc/banded_flash_bwd.cu
(K4b) recomputes p = exp(s + bias - lse) on the tensor cores (split-TF32
products, f32 accuracy), skipping 16 x 16 tiles without an edge, in two
launches: a dq kernel over receiver tiles and a dk/dv kernel over key tiles,
which writes every dk/dv row once. With `symmetric=True` (a symmetric edge
set, as GenCast's k-hop graph is: `DeviceGraph.band_symmetric`) the dk/dv
kernel streams each key block's own window and reads its masks as the dq
kernel does; otherwise it walks the receiver blocks whose window holds its
keys. The JAX package's backward takes its Pallas kernels only for
block == 512 and w % 512 == 0 (an XLA VJP otherwise); K4b takes every
layout the forward takes.

Every kernel has a plain PyTorch twin here (`banded_flash_forward_reference`,
`banded_flash_backward_reference`), written block by block so that the CPU
never holds every block's logits at once; the twins run for CPU tensors,
CUDA tensors launch the kernels. Launch counts: `LAUNCHES` (K4a),
`BWD_DQ_LAUNCHES` (K4b's dq kernel), `BWD_DKV_SYMMETRIC_LAUNCHES` and
`BWD_DKV_LAUNCHES` (its dk/dv kernel in the symmetric and the general role).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from graph_weather_tpu_torch.ops._build import c_function

LAUNCHES = 0  # K4a
BWD_DQ_LAUNCHES = 0  # K4b, dq kernel
BWD_DKV_SYMMETRIC_LAUNCHES = 0  # K4b, dk/dv kernel, symmetric role
BWD_DKV_LAUNCHES = 0  # K4b, dk/dv kernel, general role
MAX_CHANNELS = 512  # widest head the kernels' tiles hold
# Where the wider heads are queued.
WIDE_HEADS_TODO = "ROADMAP.md §2 item 4, 'Heads above c = 512'"
KEY_TILE = 512  # the JAX contract: block and 2w are multiples of it
_NEG = -1e30  # additive mask bias off an edge
_SAFE = -1e28  # running-max start: exp(_NEG - _SAFE) == 0, no inf - inf

_c_ptr, _c_int = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [
    _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # q k v masks out lse
    _c_int, _c_int, _c_int, _c_int,  # batch, n, heads, c
    _c_int, _c_int, _c_int, _c_int,  # n_blocks, block, w, vec4
    ctypes.c_float,  # scale
    _c_ptr,  # cudaStream_t
]
_BWD_ARGTYPES = [
    _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # q k v dout lse delta masks
    _c_ptr, _c_ptr, _c_ptr,  # dq dk dv
    _c_int, _c_int, _c_int, _c_int,  # batch, n, heads, c
    _c_int, _c_int, _c_int, _c_int,  # n_blocks, block, w, vec4
    ctypes.c_float, _c_int, _c_int,  # scale, mode, symmetric
    _c_ptr,  # cudaStream_t
]
DQ, DKV = 0, 1  # backward modes of the C entry (K4b's two kernels)


def _batched(*tensors):
    """Add a batch axis to [N, h, c] tensors; returns (tensors, squeeze)."""
    squeeze = tensors[0].dim() == 3
    return (tuple(t[None] for t in tensors) if squeeze else tensors), squeeze


def banded_flash_forward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    band_masks: torch.Tensor,
    block: int,
    w: int,
    with_lse: bool = False,
):
    """Plain PyTorch version, one receiver block at a time, with the kernel's
    _NEG/_SAFE arithmetic. Returns out, or (out, lse) with lse
    [B, nb * block, h] ([nb * block, h] for unbatched inputs)."""
    (q, k, v), squeeze = _batched(q, k, v)
    bsz, n, h, c = q.shape
    nb = band_masks.shape[0]
    n_pad, width = nb * block, block + 2 * w
    q_p = F.pad(q, (0, 0, 0, 0, 0, n_pad - n))
    k_p, v_p = (F.pad(t, (0, 0, 0, 0, w, n_pad - n + w)) for t in (k, v))
    out = q.new_empty((bsz, n_pad, h, c))
    lse = q.new_empty((bsz, n_pad, h))
    for b in range(nb):
        rows, win = slice(b * block, (b + 1) * block), slice(b * block, b * block + width)
        s = torch.einsum("bqhc,bjhc->bhqj", q_p[:, rows], k_p[:, win]) * (1.0 / c**0.5)
        s = torch.where(band_masks[b] != 0, s, _NEG)
        m = torch.clamp(s.amax(-1, keepdim=True), min=_SAFE)
        p = torch.exp(s - m)
        l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)  # [B, h, block, 1]
        o = torch.einsum("bhqj,bjhc->bqhc", p, v_p[:, win])
        out[:, rows] = o / l.permute(0, 2, 1, 3)
        lse[:, rows] = (m + torch.log(l))[..., 0].transpose(1, 2)
    out = out[:, :n]
    out, lse = (out[0], lse[0]) if squeeze else (out, lse)
    return (out, lse) if with_lse else out


def banded_flash_backward_reference(q, k, v, band_masks, out, lse, dout, block: int, w: int):
    """Plain PyTorch version of the backward, one receiver block at a time,
    as the kernels compute it: p recomputed from lse, ds = p (dO.v - delta)
    with delta = rowsum(dO * out), dq = ds k / sqrt(c), and each block's
    dk = ds^T q / sqrt(c), dv = p^T dO added onto its window's key rows.
    Returns (dq, dk, dv) in q's shape."""
    (q, k, v, out, dout, lse), squeeze = _batched(q, k, v, out, dout, lse)
    bsz, n, h, c = q.shape
    nb = band_masks.shape[0]
    n_pad, width = nb * block, block + 2 * w
    scale = 1.0 / c**0.5
    delta = F.pad((dout * out).sum(-1), (0, 0, 0, n_pad - n))  # [B, n_pad, h]
    q_p, do_p = (F.pad(t, (0, 0, 0, 0, 0, n_pad - n)) for t in (q, dout))
    k_p, v_p = (F.pad(t, (0, 0, 0, 0, w, n_pad - n + w)) for t in (k, v))
    dq = q.new_empty((bsz, n_pad, h, c))
    dk_p, dv_p = torch.zeros_like(k_p), torch.zeros_like(v_p)
    for b in range(nb):
        rows, win = slice(b * block, (b + 1) * block), slice(b * block, b * block + width)
        q_b, do_b, k_w, v_w = q_p[:, rows], do_p[:, rows], k_p[:, win], v_p[:, win]
        lse_b, delta_b = (t[:, rows].transpose(1, 2)[..., None] for t in (lse, delta))
        s = torch.einsum("bqhc,bjhc->bhqj", q_b, k_w) * scale
        p = torch.exp(torch.where(band_masks[b] != 0, s, _NEG) - lse_b)
        ds = p * (torch.einsum("bqhc,bjhc->bhqj", do_b, v_w) - delta_b)
        dq[:, rows] = torch.einsum("bhqj,bjhc->bqhc", ds, k_w) * scale
        dk_p[:, win] += torch.einsum("bhqj,bqhc->bjhc", ds, q_b) * scale
        dv_p[:, win] += torch.einsum("bhqj,bqhc->bjhc", p, do_b)
    dq, dk, dv = dq[:, :n], dk_p[:, w : w + n], dv_p[:, w : w + n]
    return (dq[0], dk[0], dv[0]) if squeeze else (dq, dk, dv)


def _check(q, k, v, band_masks, block, w):
    if q.dim() not in (3, 4) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "banded_flash_attention: q, k and v [N, h, c] or [B, N, h, c], one shape"
        )
    if block % KEY_TILE or (2 * w) % KEY_TILE:
        raise ValueError(f"block={block} and 2w={2 * w} must be multiples of {KEY_TILE}")
    if band_masks.dim() != 3 or band_masks.shape[1:] != (block, block + 2 * w):
        raise ValueError("banded_flash_attention: band_masks [nb, block, block + 2w]")
    if q.shape[-3] > band_masks.shape[0] * block:
        raise ValueError("banded_flash_attention: more rows than nb * block")
    if band_masks.dtype not in (torch.int8, torch.bool):
        raise TypeError("banded_flash_attention: band_masks int8 (or bool on the CPU)")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("banded_flash_attention: q, k, v must be float32")
    if any(t.device != q.device for t in (k, v, band_masks)):
        raise ValueError("banded_flash_attention: all tensors must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"banded_flash_attention: no kernel for device {q.device}")


def _check_cuda(what, c, tensors, band_masks):
    if c > MAX_CHANNELS:
        raise ValueError(
            f"{what}: head width {c} > {MAX_CHANNELS} is not ported yet. See {WIDE_HEADS_TODO}."
        )
    if band_masks.dtype != torch.int8:
        raise TypeError(f"{what}: band_masks must be int8 on the card")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")


def _sizes(q, band_masks):
    """(batch, n, heads, c, n_blocks) of a launch."""
    batch = q.shape[0] if q.dim() == 4 else 1
    return (batch,) + tuple(q.shape[-3:]) + (band_masks.shape[0],)


def _vec4(c: int, tensors) -> int:
    return int(c % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _forward_cuda(q, k, v, band_masks, block, w, with_lse):
    """K4a on the card: out, and lse [B, nb * block, h] when asked."""
    _check_cuda("banded_flash_attention", q.shape[-1], (q, k, v, band_masks), band_masks)
    batch, n, heads, c, nb = _sizes(q, band_masks)
    out = torch.empty_like(q)
    lse = None
    if with_lse:
        lse = torch.empty(q.shape[:-3] + (nb * block, heads), device=q.device)
    if out.numel() == 0:
        return out, (None if lse is None else lse.fill_(_SAFE + math.log(1e-30)))
    with torch.cuda.device(q.device):
        err = c_function("banded_flash", "gwt_banded_flash_forward", _FWD_ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), band_masks.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr(), batch, n, heads, c, nb, block, w,
            _vec4(c, (q, k, v, out)), 1.0 / c**0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"banded_flash_attention: CUDA kernel launch failed (cudaError {err})")
    global LAUNCHES
    LAUNCHES += 1
    return out, lse


def launch_backward(mode, q, k, v, band_masks, lse, dout, delta, grads, block, w, symmetric=False):
    """One K4b kernel on the card: mode 0 (`DQ`) writes grads[0] (dq), mode
    1 (`DKV`) grads[1] and grads[2] (dk, dv), in the symmetric role when
    `symmetric` (the edge set must be symmetric); delta = rowsum(dO * out),
    zero past n, [B, nb * block, h]."""
    global BWD_DQ_LAUNCHES, BWD_DKV_SYMMETRIC_LAUNCHES, BWD_DKV_LAUNCHES
    batch, n, heads, c, nb = _sizes(q, band_masks)
    outs = (grads[0], None, None) if mode == DQ else (None, grads[1], grads[2])
    with torch.cuda.device(q.device):
        err = c_function("banded_flash_bwd", "gwt_banded_flash_backward", _BWD_ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), band_masks.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in outs),
            batch, n, heads, c, nb, block, w, _vec4(c, (q, k, v, dout, *grads)),
            1.0 / c**0.5, mode, int(symmetric), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"banded_flash_attention backward ({'dq' if mode == DQ else 'dk/dv'}): "
            f"CUDA kernel launch failed (cudaError {err})"
        )
    if mode == DQ:
        BWD_DQ_LAUNCHES += 1
    elif symmetric:
        BWD_DKV_SYMMETRIC_LAUNCHES += 1
    else:
        BWD_DKV_LAUNCHES += 1


def _backward_cuda(q, k, v, band_masks, out, lse, dout, block, w, symmetric=False):
    """K4b on the card: the dq kernel, then the dk/dv kernel (its symmetric
    role when `symmetric`). Returns (dq, dk, dv)."""
    _check_cuda(
        "banded_flash_attention backward", q.shape[-1], (q, k, v, band_masks, lse, dout), band_masks
    )
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    if q.numel() == 0:
        return grads
    n_pad = band_masks.shape[0] * block
    delta = F.pad((dout * out).sum(-1), (0, 0, 0, n_pad - q.shape[-3])).contiguous()
    for mode in (DQ, DKV):
        launch_backward(mode, q, k, v, band_masks, lse, dout, delta, grads, block, w, symmetric)
    return grads


class _BandedFlashAttention(torch.autograd.Function):
    """K4a with lse forward; K4b backward (their twins on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, band_masks, block, w, symmetric):
        if q.device.type == "cpu":
            out, lse = banded_flash_forward_reference(q, k, v, band_masks, block, w, with_lse=True)
        else:
            out, lse = _forward_cuda(q, k, v, band_masks, block, w, with_lse=True)
        ctx.save_for_backward(q, k, v, band_masks, out, lse)
        ctx.block, ctx.w, ctx.symmetric = block, w, symmetric
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, band_masks, out, lse = ctx.saved_tensors
        args = (q, k, v, band_masks, out, lse, dout.contiguous(), ctx.block, ctx.w)
        if q.device.type == "cpu":
            dq, dk, dv = banded_flash_backward_reference(*args)
        else:
            dq, dk, dv = _backward_cuda(*args, symmetric=ctx.symmetric)
        return dq, dk, dv, None, None, None, None


def banded_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    band_masks: torch.Tensor,
    block: int,
    w: int,
    symmetric: bool = False,
) -> torch.Tensor:
    """Banded graph attention (see the module docstring). Returns q's shape;
    differentiable in q, k and v. `symmetric`: the edge set is symmetric
    (`DeviceGraph.band_symmetric`), so the card's dk/dv kernel takes its
    symmetric role; the result does not depend on it."""
    _check(q, k, v, band_masks, block, w)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _BandedFlashAttention.apply(q, k, v, band_masks, block, w, bool(symmetric))
    if q.device.type == "cpu":
        return banded_flash_forward_reference(q, k, v, band_masks, block, w)
    return _forward_cuda(q, k, v, band_masks, block, w, with_lse=False)[0]
