"""Clustered (gathered-neighbour) graph attention: the port of the Pallas
kernel K3a.

Receivers come in blocks of `block` rows (RCB-ordered, so a block is a
compact patch of the sphere). Block b attends to the union of its rows'
senders, gather_ids[b] ([nb, U_pad] int32, padding slots point at row 0),
through masks[b] ([nb, block, U_pad] int8 adjacency). For batch entry i,
head g and receiver row r of block b:

    out[i, r, g] = sum_u softmax_u(q.k[ids[b, u]] / sqrt(c) + bias) v[ids[b, u]]

with bias 0 on an edge and -1e30 off it, and the running max starting at
-1e28, so rows without a neighbour, and padded rows past the last receiver,
come out exactly 0; the output divides by max(l, 1e-30). q is [N, h, c] or
[B, N, h, c]; k and v are [N_kv, h, c] or [B, N_kv, h, c]; N <= nb * block.

It replaces graph_weather_tpu/ops/pallas/clustered_flash.py
(`clustered_flash_attention`, kernel `_clustered_impl` with its one-pass
and online pallas_calls). The TPU code gathered the K/V union rows in XLA
because Mosaic could not gather inside a kernel; csrc/clustered_flash.cu
gathers them itself, streams the union in key tiles through shared memory,
skips key tiles without an edge and keeps the softmax online in f32. The
dense (row, slot) work of the remaining tiles bounds it on the FP32 CUDA
cores; only 7.6% of the pairs are edges at GenCast's splits-5 layout. The
batch is a grid axis of the kernel.

`clustered_flash_attention` runs the plain PyTorch twin
`clustered_flash_attention_reference` for CPU tensors and launches the CUDA
kernel for CUDA tensors; it never falls back from one to the other.
`LAUNCHES` counts kernel launches. There is no backward yet.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = 0
MAX_CHANNELS = 512  # widest head the kernel's tiles hold
_NEG = -1e30  # additive mask bias off an edge
_SAFE = -1e28  # running-max start: exp(_NEG - _SAFE) == 0, no inf - inf
_TRAINING_TODO = "ROADMAP.md, 'K3b/K3c: the clustered attention backward'"

_c_ptr, _c_int = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [
    _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # q k v ids masks out
    _c_int, _c_int, _c_int, _c_int, _c_int,  # batch, n_q, n_kv, heads, c
    _c_int, _c_int, _c_int, _c_int,  # n_blocks, block, u_pad, vec4
    ctypes.c_float,  # scale
    _c_ptr,  # cudaStream_t
]


def clustered_flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    gather_ids: torch.Tensor,
    masks: torch.Tensor,
    block: int,
) -> torch.Tensor:
    """Plain PyTorch version: gather each block's union rows, then a dense
    masked softmax per block with the kernel's _NEG/_SAFE arithmetic (that
    of the TPU kernel's one-pass form)."""
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    bsz, n, h, c = q.shape
    nb, _ = gather_ids.shape
    n_pad = nb * block
    q_p = F.pad(q, (0, 0, 0, 0, 0, n_pad - n)).reshape(bsz, nb, block, h, c)
    ids = gather_ids.long()
    k_loc, v_loc = k[:, ids], v[:, ids]  # [B, nb, U_pad, h, c]
    s = torch.einsum("bnqhc,bnuhc->bnhqu", q_p, k_loc) * (1.0 / c**0.5)
    s = torch.where(masks[None, :, None] != 0, s, _NEG)
    m = torch.clamp(s.amax(-1, keepdim=True), min=_SAFE)
    p = torch.exp(s - m)
    l = p.sum(-1).permute(0, 1, 3, 2)[..., None]  # [B, nb, block, h, 1]
    o = torch.einsum("bnhqu,bnuhc->bnqhc", p, v_loc) / torch.clamp(l, min=1e-30)
    out = o.reshape(bsz, n_pad, h, c)[:, :n]
    return out[0] if squeeze else out


def _check(q, k, v, gather_ids, masks, block):
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.shape != k.shape:
        raise ValueError(
            "clustered_flash_attention: q [N, h, c] or [B, N, h, c]; k and v "
            "alike, with one shape"
        )
    if q.dim() == 4 and k.shape[0] != q.shape[0]:
        raise ValueError("clustered_flash_attention: batch sizes differ")
    if k.shape[-2:] != q.shape[-2:]:
        raise ValueError("clustered_flash_attention: heads or channels differ")
    if gather_ids.dim() != 2 or masks.shape != (gather_ids.shape[0], block, gather_ids.shape[1]):
        raise ValueError(
            "clustered_flash_attention: gather_ids [nb, U_pad] and masks "
            "[nb, block, U_pad]"
        )
    if q.shape[-3] > gather_ids.shape[0] * block:
        raise ValueError("clustered_flash_attention: more query rows than nb * block")
    if gather_ids.dtype != torch.int32 or masks.dtype != torch.int8:
        raise TypeError("clustered_flash_attention: gather_ids int32, masks int8")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("clustered_flash_attention: q, k, v must be float32")
    if any(t.device != q.device for t in (k, v, gather_ids, masks)):
        raise ValueError("clustered_flash_attention: all tensors must be on one device")


def clustered_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    gather_ids: torch.Tensor,
    masks: torch.Tensor,
    block: int,
) -> torch.Tensor:
    """Graph attention over per-block gathered neighbour unions (see the
    module docstring). Returns q's shape."""
    _check(q, k, v, gather_ids, masks, block)
    if q.device.type == "cpu":
        return clustered_flash_attention_reference(q, k, v, gather_ids, masks, block)
    if q.device.type != "cuda":
        raise ValueError(f"clustered_flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "clustered_flash_attention has no backward on CUDA yet; run under "
            f"torch.no_grad(). See {_TRAINING_TODO}."
        )
    tensors = (q, k, v, gather_ids, masks)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("clustered_flash_attention: tensors must be contiguous")
    c = q.shape[-1]
    if c > MAX_CHANNELS:
        raise ValueError(f"clustered_flash_attention: head width {c} > {MAX_CHANNELS}")
    batch = q.shape[0] if q.dim() == 4 else 1
    n_q, n_kv, heads = q.shape[-3], k.shape[-3], q.shape[-2]
    nb, u_pad = gather_ids.shape
    out = torch.empty_like(q)
    if out.numel() == 0 or u_pad == 0:
        return out.zero_()
    vec4 = c % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gather_ids.data_ptr(),
            masks.data_ptr(), out.data_ptr(), batch, n_q, n_kv, heads, c,
            nb, block, u_pad, int(vec4), 1.0 / c**0.5, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"clustered_flash_attention: CUDA kernel launch failed (cudaError {err})"
        )
    global LAUNCHES
    LAUNCHES += 1
    return out


def _kernel_fn():
    from graph_weather_tpu_torch.ops._build import load_library

    fn = load_library("clustered_flash").gwt_clustered_flash_forward
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn
