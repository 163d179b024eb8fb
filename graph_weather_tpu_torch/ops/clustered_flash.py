"""Clustered (gathered-neighbour) graph attention and its gradient: the port
of the Pallas kernels K3a (forward), K3b (general backward) and K3c
(symmetric backward).

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
(`clustered_flash_attention`: `_clustered_impl`, `_clustered_bwd_impl` and
`_bwd_symmetric`). The TPU code gathered the K/V union rows in XLA because
Mosaic could not gather inside a kernel; csrc/clustered_flash.cu (forward)
and csrc/clustered_flash_bwd.cu (backward) gather them themselves, skip the
16-key tiles in which a warp's 16 rows have no edge, and run every product
on the tensor cores as three TF32 products (split operands, f32 sums: f32
accuracy; csrc/clustered_tile.cuh).

bf16 (GenCast's compute policy): q, k and v may all be bf16, as the TPU
kernels take them. Both products then take bf16 operands and sum in f32;
p is rounded to bf16 before P.V, and in the backward ds before the dq and
dk products and p before the dv product; out, dq, dk and dv come back in
bf16, lse and delta stay f32, and K3b's block-local dk/dv (bf16) are summed
to global rows in f32, then rounded (the TPU code's segment sum). The
kernels' bf16 instantiations do this on one bf16 mma.sync per product.

Training: when autograd needs gradients, the forward also keeps the
log-sum-exp lse [B, nb * block, h], and the backward recomputes
p = exp(s + bias - lse). `symmetric=True` (the caller asserts that the edge
set is symmetric and that q and k/v index one node set, as for the k-hop
mesh graph) takes K3c: a dq kernel over receiver blocks and a dk/dv kernel
over key blocks that writes global rows, no scatter. Otherwise K3b: dq plus
block-local dk/dv, then a deterministic gather-sum over the inverse of
gather_ids, `scatter_index` (`meshes.clustering.build_cluster_scatter_index`;
the port's DeviceGraph builds it with a layout that is not symmetric). K3b
on the card requires it: the backward never rebuilds it on the host.

Every kernel has a plain PyTorch twin here (`clustered_flash_forward_reference`,
`clustered_flash_backward_reference`) that runs for CPU tensors; CUDA tensors
launch the kernels, never the twins. Launch counts: `LAUNCHES` (K3a),
`GENERAL_BWD_LAUNCHES` (K3b: its dq and block-local dk/dv kernels),
`SYMMETRIC_DQ_LAUNCHES` and `SYMMETRIC_DKV_LAUNCHES` (K3c's two kernels)
count the f32 kernels; `BF16_LAUNCHES`, `BF16_GENERAL_BWD_LAUNCHES`,
`BF16_SYMMETRIC_DQ_LAUNCHES` and `BF16_SYMMETRIC_DKV_LAUNCHES` the bf16 ones.
The launches at heads above WIDE_TILE_ABOVE channels, which run the W768
tiles, are also counted apart: `WIDE_LAUNCHES`, `WIDE_SYMMETRIC_DQ_LAUNCHES`,
`WIDE_SYMMETRIC_DKV_LAUNCHES` and their `BF16_WIDE_*` twins.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from graph_weather_tpu_torch.ops._build import c_function

LAUNCHES = 0  # K3a
GENERAL_BWD_LAUNCHES = 0  # K3b
SYMMETRIC_DQ_LAUNCHES = 0  # K3c, dq kernel
SYMMETRIC_DKV_LAUNCHES = 0  # K3c, dk/dv kernel
BF16_LAUNCHES = 0  # K3a, bf16
BF16_GENERAL_BWD_LAUNCHES = 0  # K3b, bf16
BF16_SYMMETRIC_DQ_LAUNCHES = 0  # K3c's dq kernel, bf16
BF16_SYMMETRIC_DKV_LAUNCHES = 0  # K3c's dk/dv kernel, bf16
WIDE_LAUNCHES = 0  # K3a at a head above WIDE_TILE_ABOVE (also in LAUNCHES)
WIDE_SYMMETRIC_DQ_LAUNCHES = 0
WIDE_SYMMETRIC_DKV_LAUNCHES = 0
BF16_WIDE_LAUNCHES = 0
BF16_WIDE_SYMMETRIC_DQ_LAUNCHES = 0
BF16_WIDE_SYMMETRIC_DKV_LAUNCHES = 0
MAX_CHANNELS = 768  # widest head K3a's and K3c's tiles hold
WIDE_TILE_ABOVE = 512  # wider heads run the W768 tiles
GENERAL_MAX_CHANNELS = 512  # widest head K3b's general dk/dv kernel holds
# Where the wider heads of K3b's general backward are queued.
WIDE_HEADS_TODO = "ROADMAP.md §2 item 4, 'Heads above c = 512'"
_NEG = -1e30  # additive mask bias off an edge
_SAFE = -1e28  # running-max start: exp(_NEG - _SAFE) == 0, no inf - inf

_c_ptr, _c_int = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [
    _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # q k v ids masks out lse
    _c_int, _c_int, _c_int, _c_int, _c_int,  # batch, n_q, n_kv, heads, c
    _c_int, _c_int, _c_int, _c_int,  # n_blocks, block, u_pad, vec
    ctypes.c_float, _c_int,  # scale, is_bf16
    _c_ptr,  # cudaStream_t
]
_BWD_ARGTYPES = [
    _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # q k v dout lse delta
    _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # ids masks dq dk dv
    _c_int, _c_int, _c_int, _c_int, _c_int,  # batch, n_q, n_kv, heads, c
    _c_int, _c_int, _c_int, _c_int,  # n_blocks, block, u_pad, vec
    ctypes.c_float, _c_int, _c_int,  # scale, mode, is_bf16
    _c_ptr,  # cudaStream_t
]
_GENERAL, _SYMMETRIC_DQ, _SYMMETRIC_DKV = 0, 1, 2  # backward modes of the C entry
DTYPES = (torch.float32, torch.bfloat16)  # what q, k and v may be (all one)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """bf16 -> f32 (exact); f32 and f64 as they are. The plain versions take
    every product on such upcasts: a bf16 x bf16 product is exact in f32."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to bf16 and back where the inputs are bf16 (where the
    TPU kernels cast an f32 intermediate to the input dtype), else t."""
    return t.to(dtype).to(t.dtype) if dtype == torch.bfloat16 else t


def clustered_flash_forward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    gather_ids: torch.Tensor,
    masks: torch.Tensor,
    block: int,
    with_lse: bool = False,
):
    """Plain PyTorch version: gather each block's union rows, then a dense
    masked softmax per block with the kernel's _NEG/_SAFE arithmetic (that
    of the TPU kernel's one-pass form). Returns out, or (out, lse) with lse
    [B, nb * block, h] ([nb * block, h] for unbatched inputs). bf16 inputs:
    products in f32 on their upcasts, p rounded to bf16 before P.V, out in
    bf16 and lse in f32."""
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    dtype = q.dtype
    q, k, v = _wide(q), _wide(k), _wide(v)
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
    l = p.sum(-1, keepdim=True)  # [B, nb, h, block, 1]
    o = torch.einsum("bnhqu,bnuhc->bnqhc", _rounded(p, dtype), v_loc)
    o = o / torch.clamp(l, min=1e-30).permute(0, 1, 3, 2, 4)
    out = o.reshape(bsz, n_pad, h, c)[:, :n].to(dtype)
    out = out[0] if squeeze else out
    if not with_lse:
        return out
    lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]  # [B, nb, h, block]
    lse = lse.permute(0, 1, 3, 2).reshape(bsz, n_pad, h)
    return out, (lse[0] if squeeze else lse)


def clustered_flash_backward_reference(
    q, k, v, gather_ids, masks, out, lse, dout, block: int, symmetric: bool = False
):
    """Plain PyTorch version of the backward, written out as the kernels
    compute it: gather, recompute p from lse, ds, the products, then the
    scatter of block-local dk/dv (general) or the transposed pass over key
    blocks (symmetric). Returns (dq, dk, dv) in q's and k's shapes and
    dtype. bf16 inputs: products in f32 on their upcasts, delta in f32, ds
    (and p before dv) rounded to bf16 before the products, block-local dk/dv
    rounded to bf16, then summed in f32 (general), every gradient rounded to
    bf16 once."""
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v, out, dout, lse = (t[None] for t in (q, k, v, out, dout, lse))
    dtype = q.dtype
    q, k, v, out, dout = (_wide(t) for t in (q, k, v, out, dout))
    bsz, n, h, c = q.shape
    n_kv = k.shape[1]
    if symmetric and n != n_kv:
        raise _node_set_error(n, n_kv)
    nb, u_pad = gather_ids.shape
    n_pad = nb * block
    scale = 1.0 / c**0.5
    ids = gather_ids.long()
    edge = masks[None, :, None] != 0  # [1, nb, 1, block, U_pad]

    def blocks(t):  # [B, rows, ...] -> [B, nb, block, ...], zero rows past the end
        pad = [0, 0] * (t.dim() - 2) + [0, n_pad - t.shape[1]]
        return F.pad(t, pad).reshape((bsz, nb, block) + t.shape[2:])

    delta = (dout * out).sum(-1)  # [B, n, h]
    delta_pad = F.pad(delta, (0, 0, 0, n_pad - n))  # [B, n_pad, h]
    lse_b = lse.reshape(bsz, nb, block, h).permute(0, 1, 3, 2)[..., None]
    delta_b = blocks(delta).permute(0, 1, 3, 2)[..., None]  # [B, nb, h, block, 1]
    q_b, do_b = blocks(q), blocks(dout)
    # Receiver blocks against their gathered key unions.
    k_loc, v_loc = k[:, ids], v[:, ids]  # [B, nb, U_pad, h, c]
    s = torch.einsum("bnqhc,bnuhc->bnhqu", q_b, k_loc) * scale
    p = torch.exp(torch.where(edge, s, _NEG) - lse_b)
    dp = torch.einsum("bnqhc,bnuhc->bnhqu", do_b, v_loc)
    ds = _rounded(p * (dp - delta_b), dtype)
    dq = torch.einsum("bnhqu,bnuhc->bnqhc", ds, k_loc) * scale
    dq = dq.reshape(bsz, n_pad, h, c)[:, :n]
    if not symmetric:
        # Block-local dk/dv (rounded as the kernel writes them), then the
        # scatter back to global rows.
        dv_loc = _rounded(torch.einsum("bnhqu,bnqhc->bnuhc", _rounded(p, dtype), do_b), dtype)
        dk_loc = _rounded(torch.einsum("bnhqu,bnqhc->bnuhc", ds, q_b) * scale, dtype)
        flat = ids.reshape(-1)
        dk = k.new_zeros(k.shape).index_add_(1, flat, dk_loc.reshape(bsz, nb * u_pad, h, c))
        dv = v.new_zeros(v.shape).index_add_(1, flat, dv_loc.reshape(bsz, nb * u_pad, h, c))
    else:
        # Key blocks against their gathered receiver unions: masks[b] read as
        # [keys, receivers] is the adjacency of a symmetric edge set.
        k_b, v_b = blocks(k), blocks(v)
        q_loc, do_loc = q[:, ids], dout[:, ids]  # [B, nb, U_pad, h, c]
        lse_loc = lse[:, ids].permute(0, 1, 3, 2)[:, :, :, None, :]  # [B, nb, h, 1, U]
        delta_loc = delta_pad[:, ids].permute(0, 1, 3, 2)[:, :, :, None, :]
        st = torch.einsum("bnkhc,bnuhc->bnhku", k_b, q_loc) * scale
        pt = torch.exp(torch.where(edge, st, _NEG) - lse_loc)
        dv = torch.einsum("bnhku,bnuhc->bnkhc", _rounded(pt, dtype), do_loc)
        dst = _rounded(pt * (torch.einsum("bnkhc,bnuhc->bnhku", v_b, do_loc) - delta_loc), dtype)
        dk = torch.einsum("bnhku,bnuhc->bnkhc", dst, q_loc) * scale
        dk, dv = (t.reshape(bsz, n_pad, h, c)[:, :n_kv] for t in (dk, dv))
    dq, dk, dv = dq.to(dtype), dk.to(dtype), dv.to(dtype)
    if squeeze:
        return dq[0], dk[0], dv[0]
    return dq, dk, dv


_NO_SCATTER_INDEX = (
    "clustered_flash_attention: the general backward (symmetric=False) on the "
    "card needs scatter_index (meshes.clustering.build_cluster_scatter_index)"
)


def _node_set_error(n_q: int, n_kv: int) -> ValueError:
    return ValueError(
        "symmetric=True requires q and k/v to index the same node set "
        f"(got {n_q} queries vs {n_kv} keys)"
    )


def _check(q, k, v, gather_ids, masks, block, symmetric):
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
    if symmetric and q.shape[-3] != k.shape[-3]:
        raise _node_set_error(q.shape[-3], k.shape[-3])
    if gather_ids.dtype != torch.int32 or masks.dtype != torch.int8:
        raise TypeError("clustered_flash_attention: gather_ids int32, masks int8")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("clustered_flash_attention: q, k, v must all be float32 or all bfloat16")
    if any(t.device != q.device for t in (k, v, gather_ids, masks)):
        raise ValueError("clustered_flash_attention: all tensors must be on one device")


def _sizes(q, k, gather_ids):
    batch = q.shape[0] if q.dim() == 4 else 1
    nb, u_pad = gather_ids.shape
    return batch, q.shape[-3], k.shape[-3], q.shape[-2], q.shape[-1], nb, u_pad


def _vec(c: int, tensors) -> int:
    """1 where every row is whole 16-byte copies (4 f32 or 8 bf16) and
    16-byte aligned: the kernels' vector copies."""
    per = 16 // tensors[0].element_size()
    return int(c % per == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def check_width(c: int, symmetric: bool = True, backward: bool = False) -> None:
    """Raise, before any launch, for a head width the card's kernels do not
    take: K3a and K3c up to MAX_CHANNELS, K3b's general backward up to
    GENERAL_MAX_CHANNELS (wider ones are queued: WIDE_HEADS_TODO). Pure host
    code: the wrapper calls it for CUDA tensors before the forward's launch
    when a general backward will follow."""
    if c > MAX_CHANNELS:
        raise ValueError(f"clustered_flash_attention: head width {c} > {MAX_CHANNELS}")
    if backward and not symmetric and c > GENERAL_MAX_CHANNELS:
        raise ValueError(
            f"clustered_flash_attention: the general backward (K3b) at head width {c} > "
            f"{GENERAL_MAX_CHANNELS} is not ported yet. See {WIDE_HEADS_TODO}."
        )


def _forward_cuda(q, k, v, gather_ids, masks, block, with_lse):
    """K3a on the card: out, and lse [B, nb * block, h] when asked."""
    if not all(t.is_contiguous() for t in (q, k, v, gather_ids, masks)):
        raise ValueError("clustered_flash_attention: tensors must be contiguous")
    batch, n_q, n_kv, heads, c, nb, u_pad = _sizes(q, k, gather_ids)
    check_width(c)
    out = torch.empty_like(q)
    lse = None
    if with_lse:
        lse = torch.empty(q.shape[:-3] + (nb * block, heads), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or u_pad == 0:
        return out.zero_(), (None if lse is None else lse.fill_(_SAFE + math.log(1e-30)))
    with torch.cuda.device(q.device):
        err = c_function("clustered_flash", "gwt_clustered_flash_forward", _FWD_ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gather_ids.data_ptr(),
            masks.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
            batch, n_q, n_kv, heads, c, nb, block, u_pad, _vec(c, (q, k, v, out)), 1.0 / c**0.5,
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"clustered_flash_attention: CUDA kernel launch failed (cudaError {err})"
        )
    global LAUNCHES, BF16_LAUNCHES, WIDE_LAUNCHES, BF16_WIDE_LAUNCHES
    wide = int(c > WIDE_TILE_ABOVE)
    if q.dtype == torch.bfloat16:
        BF16_LAUNCHES += 1
        BF16_WIDE_LAUNCHES += wide
    else:
        LAUNCHES += 1
        WIDE_LAUNCHES += wide
    return out, lse


def _launch_backward(mode, q, k, v, dout, lse, delta, gather_ids, masks, dq, dk, dv, block):
    batch, n_q, n_kv, heads, c, nb, u_pad = _sizes(q, k, gather_ids)
    tensors = [t for t in (q, k, v, dout, dq, dk, dv) if t is not None]
    with torch.cuda.device(q.device):
        err = c_function(
            "clustered_flash_bwd", "gwt_clustered_flash_backward", _BWD_ARGTYPES
        )(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), gather_ids.data_ptr(), masks.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in (dq, dk, dv)),
            batch, n_q, n_kv, heads, c, nb, block, u_pad, _vec(c, tensors),
            1.0 / c**0.5, mode, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"clustered_flash_attention backward: CUDA kernel launch failed (cudaError {err})"
        )


def _backward_cuda(q, k, v, gather_ids, masks, out, lse, dout, block, symmetric, scatter_index):
    """K3c (symmetric) or K3b on the card. Returns (dq, dk, dv) in q's dtype."""
    global GENERAL_BWD_LAUNCHES, SYMMETRIC_DQ_LAUNCHES, SYMMETRIC_DKV_LAUNCHES
    global BF16_GENERAL_BWD_LAUNCHES, BF16_SYMMETRIC_DQ_LAUNCHES, BF16_SYMMETRIC_DKV_LAUNCHES
    global WIDE_SYMMETRIC_DQ_LAUNCHES, WIDE_SYMMETRIC_DKV_LAUNCHES
    global BF16_WIDE_SYMMETRIC_DQ_LAUNCHES, BF16_WIDE_SYMMETRIC_DKV_LAUNCHES
    check_width(q.shape[-1], symmetric, backward=True)
    if not symmetric and scatter_index is None:
        raise ValueError(_NO_SCATTER_INDEX)
    if not all(t.is_contiguous() for t in (q, k, v, gather_ids, masks, lse, dout)):
        raise ValueError("clustered_flash_attention backward: tensors must be contiguous")
    batch, n_q, n_kv, heads, c, nb, u_pad = _sizes(q, k, gather_ids)
    dq = torch.empty_like(q)
    if dq.numel() == 0 or u_pad == 0:
        return dq.zero_(), torch.zeros_like(k), torch.zeros_like(v)
    # delta = rowsum(dO . out) in f32, zero on the rows past n_q: [B, nb * block, h]
    delta = (_wide(dout) * _wide(out)).sum(-1)
    delta = F.pad(delta, (0, 0, 0, nb * block - n_q)).contiguous()
    args = (q, k, v, dout, lse, delta, gather_ids, masks)
    if symmetric:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        _launch_backward(_SYMMETRIC_DQ, *args, dq, None, None, block)
        _launch_backward(_SYMMETRIC_DKV, *args, None, dk, dv, block)
        wide = int(c > WIDE_TILE_ABOVE)
        if q.dtype == torch.bfloat16:
            BF16_SYMMETRIC_DQ_LAUNCHES += 1
            BF16_SYMMETRIC_DKV_LAUNCHES += 1
            BF16_WIDE_SYMMETRIC_DQ_LAUNCHES += wide
            BF16_WIDE_SYMMETRIC_DKV_LAUNCHES += wide
        else:
            SYMMETRIC_DQ_LAUNCHES += 1
            SYMMETRIC_DKV_LAUNCHES += 1
            WIDE_SYMMETRIC_DQ_LAUNCHES += wide
            WIDE_SYMMETRIC_DKV_LAUNCHES += wide
        return dq, dk, dv
    local = q.shape[:-3] + (nb, u_pad) + q.shape[-2:]  # [B, nb, U_pad, h, c]
    dk_loc, dv_loc = (torch.empty(local, dtype=q.dtype, device=q.device) for _ in range(2))
    _launch_backward(_GENERAL, *args, dq, dk_loc, dv_loc, block)
    if q.dtype == torch.bfloat16:
        BF16_GENERAL_BWD_LAUNCHES += 1
    else:
        GENERAL_BWD_LAUNCHES += 1
    return dq, gather_sum(dk_loc, scatter_index, n_kv), gather_sum(dv_loc, scatter_index, n_kv)


def ctas_per_sm(kernel: str, c: int, block: int, u_pad: int, dtype: torch.dtype) -> int:
    """How many CTAs of a K3 kernel fit on one SM of the current card at head
    width c, this block and u_pad (registers and shared memory, by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor). kernel: "forward" (K3a),
    "dq" (K3b's and K3c's dq kernel), "general_dkv" (K3b's dk/dv kernel) or
    "symmetric_dkv" (K3c's)."""
    bf16 = int(dtype == torch.bfloat16)
    if kernel == "forward":
        fn = c_function("clustered_flash", "gwt_clustered_flash_forward_ctas", [_c_int] * 3)
        return fn(c, u_pad, bf16)
    mode = {"general_dkv": _GENERAL, "dq": _SYMMETRIC_DQ, "symmetric_dkv": _SYMMETRIC_DKV}[kernel]
    fn = c_function("clustered_flash_bwd", "gwt_clustered_flash_backward_ctas", [_c_int] * 5)
    return fn(c, block, u_pad, mode, bf16)


def gather_sum(local: torch.Tensor, scatter_index: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Block-local rows [..., nb, U_pad, h, c] -> global rows [..., n_rows, h, c]:
    row n sums local[scatter_index[n, j]] over j, in a fixed order (the
    index's padding entries point past the last slot, at a zero row). Rows
    past the index's (never gathered, as the padded rows of a processor)
    are zero. bf16 rows are summed in f32 and the sums rounded to bf16."""
    lead = local.shape[:-4]
    flat = _wide(local).reshape(lead + (-1,) + local.shape[-2:])
    flat = torch.cat([flat, flat.new_zeros(lead + (1,) + flat.shape[-2:])], dim=-3)
    out = flat.index_select(-3, scatter_index[:, 0])
    for j in range(1, scatter_index.shape[1]):
        out += flat.index_select(-3, scatter_index[:, j])
    return F.pad(out, (0, 0, 0, 0, 0, n_rows - out.shape[-3])).to(local.dtype)


class _ClusteredFlashAttention(torch.autograd.Function):
    """K3a with lse forward; K3c or K3b backward (their twins on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, gather_ids, masks, block, symmetric, scatter_index):
        if q.device.type == "cpu":
            out, lse = clustered_flash_forward_reference(
                q, k, v, gather_ids, masks, block, with_lse=True
            )
        else:
            out, lse = _forward_cuda(q, k, v, gather_ids, masks, block, with_lse=True)
        ctx.save_for_backward(q, k, v, gather_ids, masks, out, lse)
        ctx.block, ctx.symmetric, ctx.scatter_index = block, symmetric, scatter_index
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, gather_ids, masks, out, lse = ctx.saved_tensors
        args = (q, k, v, gather_ids, masks, out, lse, dout.contiguous(), ctx.block, ctx.symmetric)
        if q.device.type == "cpu":
            dq, dk, dv = clustered_flash_backward_reference(*args)
        else:
            dq, dk, dv = _backward_cuda(*args, ctx.scatter_index)
        return dq, dk, dv, None, None, None, None, None


def clustered_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    gather_ids: torch.Tensor,
    masks: torch.Tensor,
    block: int,
    symmetric: bool = False,
    scatter_index: torch.Tensor | None = None,
) -> torch.Tensor:
    """Graph attention over per-block gathered neighbour unions (see the
    module docstring). Returns q's shape. Differentiable in q, k and v;
    `symmetric` picks the backward (K3c when True, else K3b), and
    `scatter_index` is K3b's inverse of gather_ids, required when K3b runs
    on the card."""
    _check(q, k, v, gather_ids, masks, block, symmetric)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"clustered_flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.device.type == "cuda":
            check_width(q.shape[-1], symmetric, backward=True)
            if not symmetric and scatter_index is None:
                raise ValueError(_NO_SCATTER_INDEX)
        return _ClusteredFlashAttention.apply(
            q, k, v, gather_ids, masks, block, symmetric, scatter_index
        )
    if q.device.type == "cpu":
        return clustered_flash_forward_reference(q, k, v, gather_ids, masks, block)
    return _forward_cuda(q, k, v, gather_ids, masks, block, with_lse=False)[0]
