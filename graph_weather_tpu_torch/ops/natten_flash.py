"""3D neighborhood attention on the card and its gradient: the port of the
Pallas kernels K5a (forward, `_flash_fwd_impl`) and K5b (backward,
`_flash_bwd_impl`) of graph_weather_tpu/ops/pallas/natten_flash.py.

The semantics are those of ops/neighborhood_attention.py: q, k, v
[B, D, H, W, heads, ch] f32 or bf16, clamped windows (a circular W axis on request),
q scaled by ch^-0.5, rpb [heads, 2kd-1, 2kh-1, 2kw-1] added by relative
offset. The TPU kernel cut the volume into blocks attended densely against
a gathered halo, with per-class masks and a head-block-diagonal key matrix
so that Mosaic's 128-lane matrix unit could do the work; the CUDA kernels
compute only the kd * kh * kw pairs of each query:

  * K5a (csrc/natten_flash.cu): one CTA per tile of td x th query rows
    (one warp each) of TW W-columns, of one (batch, head); a group of lanes
    owns four W-neighbouring queries, so that every k or v element read
    from shared memory feeds four queries. The CTA walks the key planes of
    its tile's D windows one at a time: a slab is the union of its
    queries' windows in that plane, K and V, staged in shared memory with
    cp.async in two stages (the next strip of the slab in flight while the
    current one is computed); per key row a group takes its queries' union
    of W-columns in chunks, sums the partial logits by a reduce-scatter of
    shuffles, and each query runs an online softmax in log2 units (exp2 of
    x - m) once per chunk. Writes out and, for training, lse
    [B, D, H, W, heads]. `_fwd_plan` picks the lane group, the tile and the
    slab strip from the shape, before any launch.
  * K5b (csrc/natten_flash_bwd.cu), two kernels and no atomics:
    (i) dq over query tiles (the same halo), recomputing p = exp(s - lse)
    and ds = p (dO.v - delta), delta = rowsum(dO * out); it also writes, per
    CTA, the sums of ds over each relative offset, [n_cta, heads, n_rel],
    which one torch sum turns into drpb; (ii) dk/dv over key tiles: each key
    walks the queries whose window holds it (per axis a contiguous range,
    of at most k + k//2 positions on an axis of 2k or more) and writes dk
    and dv itself; the CTA stages the union of its keys' ranges (the
    inverse window) one D plane at a time, in strips of `_dkv_rows` rows,
    q and dO rows, lse and delta. This replaces
    the TPU kernel's block-local dk/dv, XLA overlap-add and segment-sum.
    A group of lanes owns W-neighbouring positions, so one row read from
    shared memory serves them all: four queries on ch/4 lanes in the dq
    kernel, two keys on ch/8 lanes in the dk/dv kernel.

The host picks K5b's tiles (`_pick_tile`): among tiles of at most 128
queries (64 at ch <= 64, 32 at ch <= 128) whose halo fits Hopper's 227 KB,
the one that stages the fewest halo rows over the whole volume. The same
choice for kind "fwd" decides which shapes K5a takes, as before its slabs:
ch <= 128 (MAX_CHANNELS), and a halo that fits in shared memory (ch <= 64
fits every kernel up to (5, 7, 7); ch of 96 or 128 does not fit (5, 7, 7)),
so that no shape moves between K5a, K6 and an error. `takes` says, before
any launch, whether the kernels take a shape; impl="auto" of
`neighborhood_attention_3d` sends the shapes they refuse to the wide-head
K6 (ops/natten3d.py), impl="flash" raises ValueError for them.

The plain versions are `neighborhood_attention_3d_reference` (the forward,
in ops/neighborhood_attention.py) and `natten_flash_backward_reference`
(the backward, written out as K5b computes it). `neighborhood_attention_3d`
dispatches: CPU tensors take the plain versions, CUDA tensors launch the
kernels or raise (`launch_backward` launches one K5b kernel). Launch
counts: `LAUNCHES` (K5a), `BWD_DQ_LAUNCHES` and `BWD_DKV_LAUNCHES` (K5b's
two kernels).

bf16 q, k, v and rpb take K5a's and K5b's bf16 modes, with the TPU kernels'
roundings (the plain versions `flash_forward_reference` and
`natten_flash_backward_reference` on bf16): q-hat = bf16(q x bf16 scale), p
rounded after its normalisation (K5a walks its slabs twice), ds and p
rounded before their products, dk and dv rounded per TPU query tile
(`tpu_backward_tile`). Counts `BF16_LAUNCHES`, `BF16_BWD_DQ_LAUNCHES`,
`BF16_BWD_DKV_LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from graph_weather_tpu_torch.ops._build import c_function
from graph_weather_tpu_torch.ops.neighborhood_attention import (
    _gather,
    _slot_bias,
    _slot_tables,
    _slots,
    bf16_scale,
    neighborhood_attention_3d_reference,
    round_bf16,
    scaled_q,
)

LAUNCHES = 0  # K5a
BWD_DQ_LAUNCHES = 0  # K5b, dq and drpb partials
BWD_DKV_LAUNCHES = 0  # K5b, dk and dv
BF16_LAUNCHES = 0  # K5a in bf16
BF16_BWD_DQ_LAUNCHES = 0  # K5b in bf16, dq and drpb partials
BF16_BWD_DKV_LAUNCHES = 0  # K5b in bf16, dk and dv
MAX_CHANNELS = 128  # widest head a lane group holds (4 lanes x 32 channels)
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper
_TILES = [(td, th, tw) for td in (1, 2, 4) for th in (1, 2, 4, 8) for tw in (4, 8, 16)]

_c_ptr, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GEOMETRY = [
    _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,  # batch, D, H, W, heads, ch
    _c_ll, _c_ll, _c_ll,  # position strides of q, k, v (in floats)
    _c_int, _c_int, _c_int, _c_int,  # kd, kh, kw, circular_w
    _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,  # tile td th tw, halo ud uh uw
    _c_int, ctypes.c_float,  # vec4, scale
    _c_ptr,  # cudaStream_t
]
# q k v rpb out lse, batch D H W heads ch, strides, kd kh kw circular_w vec4,
# scale, the plan (cp lanes nc td th ry rx), the stream
_FWD_ARGTYPES = ([_c_ptr] * 6 + _GEOMETRY[:13] + [_c_int, ctypes.c_float] + [_c_int] * 7
                 + [_c_ptr])
# mode, q k v rpb dout lse delta dq dk dv partial, the geometry, ry (rows of a
# dk/dv strip), the stream
_BWD_ARGTYPES = [_c_int] + [_c_ptr] * 11 + _GEOMETRY[:-1] + [_c_int, _c_ptr]
# the bf16 entries: as the f32 ones (the forward's the same); the backward's
# also takes, before the stream, the TPU kernel's query tile (th, tw), the
# dk/dv kernel's CTAs an SM, and out and the delta the dq kernel forms
_BWD16_ARGTYPES = _BWD_ARGTYPES[:-1] + [_c_int, _c_int, _c_int, _c_ptr, _c_ptr, _c_ptr]
DQ, DKV = 0, 1  # backward modes of the C entry (K5b's two kernels)


# ---------------------------------------------------------------------------
# Plain backward
# ---------------------------------------------------------------------------


def _scatter_add(dst, tables, slot, src):
    """dst += the adjoint of _gather(., tables, slot) applied to src."""
    for axis in (3, 2, 1):
        idx = tables[axis - 1][0][:, slot[axis - 1]]
        src = torch.zeros_like(src).index_add_(axis, idx, src)
    dst += src


_SAFE = -1e28  # the floor of each query's max in the TPU kernel's softmax


def flash_forward_reference(q, k, v, kernel, rpb=None, circular_w=False, with_lse=False):
    """Plain PyTorch version of K5a. On f32 tensors the slot scan
    (`neighborhood_attention_3d_reference`); on bf16 the TPU kernel's
    roundings: q-hat (`scaled_q`), f32 logits plus the bf16 bias, each
    query's max (floored at -1e28) and sum l of exp(s - max) over its whole
    window, p-hat = bf16(exp(s - max) / l), out = bf16(sum p-hat v) summed
    in f32 (q-hat rounded to bf16: `scaled_q(q, rounded=True)`). Returns out, or (out, lse)."""
    if q.dtype != torch.bfloat16:
        return neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular_w, with_lse)
    tables = _slot_tables(q.shape, kernel, circular_w, q.device)
    qs = scaled_q(q, rounded=True)
    logits = []
    for slot in _slots(kernel):
        s = (qs * _gather(k, tables, slot).float()).sum(-1)
        if rpb is not None:
            s = s + _slot_bias(rpb, tables, slot).float()
        logits.append(s)
    logits = torch.stack(logits, -1)  # [B, D, H, W, heads, slots]
    m = logits.max(-1).values.clamp(min=_SAFE)
    e = torch.exp(logits - m[..., None])
    l = e.sum(-1)
    p = round_bf16(e / l.clamp(min=1e-30)[..., None])
    out = torch.zeros(q.shape, device=q.device)
    for i, slot in enumerate(_slots(kernel)):
        out += p[..., i, None] * _gather(v, tables, slot).float()
    out = out.to(torch.bfloat16)
    return (out, m + torch.log(l.clamp(min=1e-30))) if with_lse else out


# ---------------------------------------------------------------------------
# The TPU kernel's backward tiles, whose bf16 dk and dv partials it rounds
# ---------------------------------------------------------------------------

_TPU_BWD_BUDGET = 36 * 2**20  # bytes of VMEM the TPU kernel's backward tile may take


def _tpu_halo(k: int, circular: bool) -> tuple[int, int]:
    return (k // 2, k // 2) if circular else (k - 1, k // 2)


def _tpu_patterns(size: int, k: int, tile: int, circular: bool) -> int:
    """How many distinct per-tile window masks an axis has (the TPU kernel's
    mask classes)."""
    c = k // 2
    back, front = _tpu_halo(k, circular)
    u = tile + back + front
    q_off, k_off = np.arange(tile), np.arange(u)
    seen = set()
    for t in range(-(-size // tile)):
        q_abs, k_raw = t * tile + q_off, t * tile - back + k_off
        if circular:
            delta = np.mod(np.mod(k_raw, size)[None, :] - q_abs[:, None] + c, size) - c
            member, k_ok = np.abs(delta) <= c, np.ones(u, bool)
        else:
            start = np.clip(q_abs - c, 0, size - k)
            member = (k_raw[None, :] >= start[:, None]) & (k_raw[None, :] < start[:, None] + k)
            k_ok = (k_raw >= 0) & (k_raw < size)
        seen.add((member & (q_abs < size)[:, None] & k_ok[None, :]).tobytes())
    return len(seen)


@functools.lru_cache(maxsize=64)
def tpu_backward_tile(dims, kernel, circular_w: bool, heads: int, ch: int, has_bias: bool):
    """(th, tw): the H x W extent of the query tiles (all of D) over which
    the JAX package's bf16 K5b sums each key's dk and dv before rounding
    them to bf16 (graph_weather_tpu/ops/pallas/natten_flash.py, the tile
    `_flash_bwd_impl` picks within its VMEM budget: the candidate of least
    halo whose modelled bytes fit). None where no tile fits: the JAX package
    then differentiates its slot scan; the port rounds each key's sums once
    there (ROADMAP.md, "bf16 policies"). A pure host function."""
    (d, h, w), (_, kh, kw) = dims, kernel
    hc, hpg = heads * ch, max(1, 128 // ch)
    bh, fh = _tpu_halo(kh, False)
    bw, fw = _tpu_halo(kw, circular_w)
    cands = [(th, tw) for th in (16, 12, 8, 6, 4, 3, 2, 1) for tw in (16, 12, 8, 6, 4, 3, 2, 1)
             if th >= kh // 2 + 1 and tw >= kw // 2 + 1 and not (circular_w and tw + bw + fw > w)
             and (d * th * tw) % 8 == 0]
    cands.sort(key=lambda c: ((c[0] + bh + fh) * (c[1] + bw + fw) / (c[0] * c[1]), -c[0] * c[1]))
    for th, tw in cands:
        if th > h or tw > w:
            continue
        block = d * th * tw
        u_pad = -(-d * (th + bh + fh) * (tw + bw + fw) // 128) * 128
        wide = hpg * u_pad
        n_cls = _tpu_patterns(h, kh, th, False) * _tpu_patterns(w, kw, tw, circular_w)
        est = (4 * block * wide * 4 + (block * wide * 6 if has_bias else 0) + 2 * 128 * wide * 2
               + 2 * wide * 128 * 2 + 2 * 128 * wide * 4 + n_cls * block * u_pad
               + 4 * block * 128 * 2 + 2 * block * 128 * 4 + 2 * 128 * u_pad * 2)
        if est <= _TPU_BWD_BUDGET:
            return th, tw
    return None


def natten_flash_backward_reference(
    q, k, v, rpb, out, lse, dout, kernel, circular_w=False
):
    """Plain PyTorch version of K5b, written out as the kernels compute it:
    per window slot, p = exp(s - lse), ds = p (dO.v - delta); dq and drpb
    on the query side, dk and dv scattered back to the keys. Returns
    (dq, dk, dv, drpb), drpb None without rpb.

    On bf16 tensors the TPU kernel's roundings (f32 sums throughout): delta
    = dO . out of the bf16 out; ds and p rounded to bf16 before their
    products; dq = bf16(sum ds k * ch^-0.5); dk = sum ds q-hat and dv = sum
    p dO summed per key over the queries of each of the TPU kernel's tiles
    (`tpu_backward_tile`: all of D by th x tw of H and W), each tile's part
    rounded to bf16, the parts added in f32 and rounded (one part where no
    tile fits); drpb the f32 sum of ds per offset, rounded once."""
    bf16 = q.dtype == torch.bfloat16
    tables = _slot_tables(q.shape, kernel, circular_w, q.device)
    heads, ch = q.shape[-2:]
    scale = ch**-0.5
    qs = scaled_q(q, rounded=True)
    g, o = dout.float(), out.float()
    delta = (g * o).sum(-1)  # [B, D, H, W, heads]
    dq, dk, dv = (torch.zeros(q.shape, device=q.device) for _ in range(3))
    drpb = None
    if rpb is not None:
        _, nh, nw = rpb.shape[1:]
        drpb = torch.zeros(heads, rpb[0].numel(), device=q.device)
        (_, rd), (_, rh), (_, rw) = tables
    if bf16:
        parts = _TileParts(q.shape, kernel, circular_w, rpb is not None, tables)
    for slot in _slots(kernel):
        ks, vs = _gather(k, tables, slot).float(), _gather(v, tables, slot).float()
        s = (qs * ks).sum(-1)
        if rpb is not None:
            s = s + _slot_bias(rpb, tables, slot).float()
        p = torch.exp(s - lse)
        ds = p * ((g * vs).sum(-1) - delta)
        if bf16:
            ds_p = round_bf16(ds)
            dq += ds_p[..., None] * ks
            parts.add(slot, ds_p[..., None] * qs, round_bf16(p)[..., None] * g)
        else:
            dq += ds[..., None] * ks
            _scatter_add(dk, tables, slot, ds[..., None] * qs)
            _scatter_add(dv, tables, slot, p[..., None] * g)
        if rpb is not None:
            x, y, z = slot
            rel = (rd[:, x, None, None] * nh + rh[None, :, y, None]) * nw + rw[None, None, :, z]
            drpb.index_add_(1, rel.reshape(-1), ds.sum(0).reshape(-1, heads).T)
    dq *= scale
    if drpb is not None:
        drpb = drpb.reshape(rpb.shape)
    if bf16:
        dk, dv = parts.sums()
        return tuple(None if t is None else t.to(torch.bfloat16) for t in (dq, dk, dv, drpb))
    return dq, dk, dv, drpb


class _TileParts:
    """Each key's dk and dv parts per query tile of the TPU kernel
    (`tpu_backward_tile`), f32, for the bf16 plain backward: a key's
    queries lie in at most `span` tiles of each axis, counted from the tile
    of its first query; `sums` rounds each part to bf16 and adds them."""

    def __init__(self, shape, kernel, circular_w, has_bias, tables):
        b, d, h, w, heads, ch = shape
        tile = tpu_backward_tile((d, h, w), tuple(kernel), bool(circular_w), heads, ch, has_bias)
        th, tw = tile if tile is not None else (h, w)
        self.tables, self.shape = tables, shape
        dev = tables[0][0].device
        # per axis: each query's tile, and each key's first query's tile
        self.tile_h = torch.arange(h, device=dev) // th
        self.tile_w = torch.arange(w, device=dev) // tw
        ch_, cw = kernel[1] // 2, kernel[2] // 2
        first_h = torch.tensor([0 if j < kernel[1] else j - (kernel[1] - 1 - ch_) for j in range(h)],
                               device=dev)
        first_w = torch.tensor([(j - (kernel[2] - 1 - cw)) % w if circular_w else
                                (0 if j < kernel[2] else j - (kernel[2] - 1 - cw)) for j in range(w)],
                               device=dev)
        self.base_h, self.base_w = first_h // th, first_w // tw
        self.n_tw = -(-w // tw)
        self.nh = -(-(kernel[1] + ch_) // th) + 1
        self.nw = min(self.n_tw, -(-kernel[2] // tw) + 2) if circular_w else -(-(kernel[2] + cw) // tw) + 1
        n = b * d * h * w
        self.dk = torch.zeros(n * self.nh * self.nw, heads * ch, device=dev)
        self.dv = torch.zeros_like(self.dk)

    def add(self, slot, ck, cv):
        """The slot's contributions ck, cv [B, D, H, W, heads, ch] at their
        queries, into their keys' parts."""
        b, d, h, w, heads, ch = self.shape
        (idx_d, _), (idx_h, _), (idx_w, _) = self.tables
        x, y, z = slot
        kd_, kh_, kw_ = idx_d[:, x], idx_h[:, y], idx_w[:, z]  # each query's key, per axis
        rel_h = self.tile_h - self.base_h[kh_]  # [H] the query's tile from its key's first
        rel_w = torch.remainder(self.tile_w - self.base_w[kw_], self.n_tw)
        key = ((torch.arange(b, device=kd_.device)[:, None, None, None] * d + kd_[None, :, None, None])
               * h + kh_[None, None, :, None]) * w + kw_[None, None, None, :]
        if int(rel_h.max()) >= self.nh or int(rel_w.max()) >= self.nw:
            raise AssertionError("a key's queries span more tiles than its parts hold")
        part = rel_h[None, None, :, None] * self.nw + rel_w[None, None, None, :]
        rows = (key * (self.nh * self.nw) + part).reshape(-1)
        self.dk.index_add_(0, rows, ck.reshape(-1, heads * ch))
        self.dv.index_add_(0, rows, cv.reshape(-1, heads * ch))

    def sums(self):
        parts = self.nh * self.nw
        return tuple(round_bf16(t).view(-1, parts, t.shape[-1]).sum(1).view(self.shape)
                     for t in (self.dk, self.dv))


# ---------------------------------------------------------------------------
# Tiles
# ---------------------------------------------------------------------------


def _window_span(i0, i1, size, k, circular):
    """Queries [i0, i1) of one axis -> (first key, number of keys) of the
    union of their windows. On a circular axis the first key may be
    negative (taken modulo size)."""
    if circular:
        return i0 - k // 2, min(i1 - i0 + k - 1, size)
    lo = min(max(i0 - k // 2, 0), size - k)
    hi = min(max(i1 - 1 - k // 2, 0), size - k) + k
    return lo, hi - lo


def _inverse_span(j0, j1, size, k, circular):
    """Keys [j0, j1) of one axis -> (first query, number of queries) whose
    window holds one of them: key j is in the windows of queries
    (0 if j < k else j - (k - 1 - k//2)) .. (size - 1 if j >= size - k else
    j + k//2)."""
    c = k // 2
    if circular:
        return j0 - (k - 1 - c), min(j1 - j0 + k - 1, size)
    lo = 0 if j0 < k else j0 - (k - 1 - c)
    hi = size - 1 if j1 - 1 >= size - k else j1 - 1 + c
    return lo, hi - lo + 1


def _max_span(size, k, tile, circular, inverse):
    span = _inverse_span if inverse else _window_span
    return max(span(i0, min(i0 + tile, size), size, k, circular)[1] for i0 in range(0, size, tile))


def _padded_width(ch: int) -> int:
    """Channels a query's four lanes hold: 16, 32, 64 or 128."""
    return max(16, 1 << (ch - 1).bit_length())


def _max_queries(cp: int) -> int:
    """Queries per CTA (four threads each) that the kernel for width cp takes."""
    return {16: 128, 32: 128, 64: 64, 128: 32}[cp]


@dataclass(frozen=True)
class Tile:
    td: int
    th: int
    tw: int
    ud: int  # the most positions any tile stages, per axis
    uh: int
    uw: int
    smem: int  # bytes of shared memory per CTA
    n_tiles: int


@functools.lru_cache(maxsize=64)
def _pick_tile(kind, dims, kernel, circular_w, ch, has_bias) -> Tile:
    """The tile of `kind` ("fwd", "dq" or "dkv"; see the module docstring).
    The dk/dv kernel's tile is chosen by rpb's shared memory alone; it
    stages its inverse window in strips that fit (`_dkv_rows`)."""
    if ch > MAX_CHANNELS:
        raise ValueError(f"natten_flash: head width {ch} > {MAX_CHANNELS}")
    cp = _padded_width(ch)
    n_rel = math.prod(2 * kk - 1 for kk in kernel)
    circular = (False, False, circular_w)
    best, best_score = None, None
    for tile in _TILES:
        tq = math.prod(tile)
        if tq > _max_queries(cp):
            continue
        spans = [
            _max_span(size, kk, t, circ, kind == "dkv")
            for size, kk, t, circ in zip(dims, kernel, tile, circular)
        ]
        rows = math.prod(spans)
        smem = 4 * n_rel
        if kind != "dkv":
            smem += 2 * 4 * rows * (cp + 4)  # K and V, rows padded by 4 floats
        if kind == "dq" and has_bias:
            smem += 4 * tq * math.prod(kernel)  # ds of every (query, slot)
        if smem > SMEM_LIMIT:
            continue
        n_tiles = math.prod(-(-size // t) for size, t in zip(dims, tile))
        score = (n_tiles * (rows + tq), n_tiles)  # staged rows and query threads
        if best_score is None or score < best_score:
            best, best_score = Tile(*tile, *spans, smem, n_tiles), score
    if best is None:
        raise ValueError(
            f"natten_flash: no tile of volume {dims} x ch {ch} at kernel {kernel} fits "
            f"{SMEM_LIMIT} bytes of shared memory"
        )
    return best


def _dkv_smem(ry: int, uw: int, cp: int, n_rel: int) -> int:
    """Bytes of shared memory of the dk/dv kernel: rpb, and two stages of a
    strip of ry rows x uw columns of q and dO rows, lse and delta."""
    stage = -(-ry * uw * (2 * (cp + 4) + 2) // 4) * 4
    return 4 * (-(-n_rel // 4) * 4 + 2 * stage)


def _dkv_rows(tile: Tile, kernel, ch: int) -> int:
    """Rows of the inverse window's strips that the dk/dv kernel stages at
    once: the most, up to a whole plane (tile.uh), that fit in shared
    memory. At WeatherMesh's shapes (ch 32, kernels (3, 5, 5) and (5, 7, 7))
    a whole plane fits. 0 where not even one row fits (a W window of ~70
    and more at 128 channels): the kernel then reads its queries through
    L1, unstaged."""
    cp = _padded_width(ch)
    n_rel = math.prod(2 * kk - 1 for kk in kernel)
    return max((ry for ry in range(1, tile.uh + 1) if _dkv_smem(ry, tile.uw, cp, n_rel) <= SMEM_LIMIT),
               default=0)


# K5b·bf16's dk/dv kernel (csrc/natten_flash_bwd.cu, `natten_dkv_bf16_kernel`):
# a warp owns DKV16_PATCH (rows, columns) = 16 keys of one plane, the rows of
# its bf16 mma tiles, and a table of DKV16_SLICE queries (DKV16_TABLE bytes);
# a CTA of at most DKV16_MAX_WARPS warps owns a key tile (td, th, tw) of whole
# patches and stages items of its inverse window (all planes and columns, ry
# rows), q-hat and dO as bf16 rows of CP + 8 elements, lse and delta, in two
# stages. It is compiled for one CTA an SM and, for CTAs of at most 4 warps,
# for DKV16_SMALL_CTAS (170 registers; two CTAs of 8 warps spill at 128).
DKV16_PATCH = (4, 4)
DKV16_MAX_WARPS = 8
DKV16_SLICE, DKV16_TABLE = 64, 64 * 24
DKV16_SMALL_CTAS = 3
DKV16_TILES = [(td, th, tw) for td in (1, 2, 4) for th in (4, 8, 16) for tw in (4, 8, 16)
               if td * (th // 4) * (tw // 4) <= DKV16_MAX_WARPS]


@dataclass(frozen=True)
class Dkv16Plan:
    """A launch of K5b·bf16's dk/dv kernel: its key tile (`tile`, with the
    inverse window's largest spans and the shared memory of a CTA), `ry`
    rows an item stages, the TPU query tile (jth, jtw) whose parts it
    rounds, `whole` (an item holds a TPU tile of H's rows of the window),
    warps a CTA and CTAs an SM."""

    tile: Tile
    ry: int
    jth: int
    jtw: int
    whole: bool
    warps: int
    ctas: int


def _dkv16_stage(ud: int, ry: int, uw: int, cp: int) -> int:
    """Bytes of one stage: ud x ry x uw positions of q-hat and dO rows (bf16,
    cp + 8 a row), lse and delta, rounded up to 16."""
    return -(-ud * ry * uw * (4 * (cp + 8) + 8) // 16) * 16


def dkv16_tile_plan(tile, dims, kernel, circular_w, jt, ch) -> Dkv16Plan | None:
    """K5b·bf16's dk/dv kernel on key tile `tile` (whole patches, at most
    DKV16_MAX_WARPS of them), TPU query tile jt: ry the most rows up to a
    TPU tile of H's (the window's rows in one, `whole`) whose two stages fit;
    None where not even one row does."""
    cp = _padded_width(ch)
    (td, th, tw), (ph, pw) = tile, DKV16_PATCH
    warps = td * (th // ph) * (tw // pw)
    if th % ph or tw % pw or not 1 <= warps <= DKV16_MAX_WARPS:
        return None
    n_rel = math.prod(2 * kk - 1 for kk in kernel)
    fixed = 4 * (-(-n_rel // 4) * 4) + warps * DKV16_TABLE  # rpb, the query tables
    ud, uh, uw = (_max_span(size, kk, t, circ, True)
                  for size, kk, t, circ in zip(dims, kernel, tile, (False, False, circular_w)))
    rows = min(jt[0], uh)
    fits = [r for r in range(rows, 0, -1) if fixed + 2 * _dkv16_stage(ud, r, uw, cp) <= SMEM_LIMIT]
    if not fits:
        return None
    ry = fits[0]
    smem = fixed + 2 * _dkv16_stage(ud, ry, uw, cp)
    small = warps <= 4 and DKV16_SMALL_CTAS * (smem + 1024) <= SM_SMEM
    ctas = DKV16_SMALL_CTAS if small else 1
    n_tiles = math.prod(-(-size // t) for size, t in zip(dims, tile))
    return Dkv16Plan(Tile(td, th, tw, ud, uh, uw, smem, n_tiles), ry, jt[0], jt[1], ry == rows, warps, ctas)


@functools.lru_cache(maxsize=64)
def dkv_bf16_plan(dims, kernel, circular_w, heads, ch, has_bias) -> Dkv16Plan:
    """How K5b·bf16's dk/dv kernel tiles the keys (a pure host function,
    called before any launch). A key's dk and dv are summed per TPU query
    tile (`tpu_backward_tile`; the whole H and W where it has none), so the
    kernel walks its items (`dkv_bf16_items`) one TPU tile at a time. Among
    the key tiles of `DKV16_TILES`: whole items first, then the most warps
    resident an SM (the CTAs an SM it is compiled for times its warps), then
    the fewest positions staged over the volume."""
    tpu = tpu_backward_tile(dims, kernel, circular_w, heads, ch, has_bias)
    jt = tpu if tpu is not None else dims[1:]
    plans = [p for t in DKV16_TILES if (p := dkv16_tile_plan(t, dims, kernel, circular_w, jt, ch))]
    if not plans:
        raise ValueError(f"K5b bf16 dk/dv: no key tile stages a row of {dims}, kernel {kernel}, "
                         f"{ch} channels")
    return min(plans, key=lambda p: (not p.whole, -p.ctas * p.warps,
                                     p.tile.n_tiles * p.tile.ud * p.tile.uh * p.tile.uw))


def dkv_bf16_segments(c_lo: int, c_end: int, w: int, jtw: int) -> list[tuple[int, int]]:
    """The pieces [c0, c1) of unreduced columns [c_lo, c_end) (circular ones
    possibly below 0 or past w) cut where a TPU tile of W ends, in wrapped
    columns (none where one tile spans W): each is one part of a key's dk
    and dv. The kernel's `seg_end`."""
    out, c = [], c_lo
    while c < c_end:
        if jtw >= w:
            e = c_end
        else:
            x = c % w
            e = min(c_end, c + min((x // jtw + 1) * jtw, w) - x)
        out.append((c, e))
        c = e
    return out


def dkv_bf16_items(lo_h: int, span_h: int, c_lo: int, c_end: int, w: int, jth: int, jtw: int,
                   ry: int) -> list[tuple[int, int, int, int, bool]]:
    """The items (y0, y1, c0, c1, closes) of K5b·bf16's dk/dv kernel over a
    key tile's inverse window (rows [lo_h, lo_h + span_h), unreduced columns
    [c_lo, c_end)): rows [y0, y1) staged, the parts of columns [c0, c1)
    walked, closed at the item's end where `closes`. Where ry holds a TPU
    tile of H's rows of the window, one item a tile of H with all the
    columns; else items of ry rows, for each TPU tile of W in turn over the
    tile of H's rows. The kernel's `first` and `next`."""
    hi = lo_h + span_h
    whole = ry >= min(jth, span_h)
    segs = dkv_bf16_segments(c_lo, c_end, w, jtw)
    out, y = [], lo_h
    while y < hi:
        te = min(hi, (y // jth + 1) * jth)
        if whole:
            out.append((y, te, c_lo, c_end, True))
        else:
            for c0, c1 in segs:
                out.extend((y0, min(y0 + ry, te), c0, c1, min(y0 + ry, te) == te)
                           for y0 in range(y, te, ry))
        y = te
    return out


# K5a's launch (csrc/natten_flash.cu): W-neighbouring queries of a lane
# group (NQ), the columns of a chunk up to kw = 5 and above (NC_SHORT,
# NC_LONG), threads of a CTA (THREADS: eight query rows), and per padded
# head width the channels a lane holds and the CTAs an SM that the
# instantiation's registers allow (its __launch_bounds__).
FWD_NQ = 4
FWD_NC = (8, 10)
FWD_THREADS = 256
FWD_GROUPS = {16: (4, 2), 32: (4, 2), 64: (8, 1), 128: (8, 1)}
SM_SMEM = 233472  # bytes of shared memory of an SM; each CTA also takes 1 KB
FWD_ROWS = ((1, 8), (2, 4), (4, 2), (8, 1))  # (td, th): query planes and rows of a CTA
ITEM_COST = 2  # an item's barrier and copies, in key-row chunks of one warp


@dataclass(frozen=True)
class FwdPlan:
    """A launch of K5a: padded head width `cp`, `lanes` lanes to a group of
    FWD_NQ W-neighbouring queries, `nc` columns a chunk; td x th query rows
    (one warp each) of `tw` columns a CTA; items of ry union rows by rx
    union columns of a key plane's slab; the shared memory it takes, the
    CTAs an SM holds, and the tiles over the volume."""

    cp: int
    lanes: int
    nc: int
    td: int
    th: int
    tw: int
    ry: int
    rx: int
    smem: int
    ctas: int
    n_tiles: int


def _fwd_item(uh, uw, budget, row_bytes):
    """The largest item (ry, rx) of a slab of uh x uw positions that fits
    `budget` bytes at `row_bytes` a staged position, in strips of equal
    heights (widths); None when not even one position fits."""
    if budget < row_bytes:
        return None
    rx = min(uw, budget // row_bytes)
    ry = min(uh, budget // (row_bytes * rx))
    rx = -(-uw // -(-uw // rx))
    ry = -(-uh // -(-uh // ry))
    return ry, rx


@functools.lru_cache(maxsize=64)
def _fwd_plan(dims, kernel, circular_w, ch, has_bias) -> FwdPlan:
    """How K5a tiles q of volume `dims` at `kernel` (a pure host function,
    called before any launch): for each split of the CTA's eight warps into
    td query planes by th query rows, and each number of CTAs an SM (up to
    what the registers allow), the largest slab strip that rpb and two
    stages of K and V leave room for; then the plan whose critical path
    over the volume is shortest: per CTA the items times the most key rows
    a warp walks in one (all its rows in a whole slab, fewer in a strip),
    in chunks, plus ITEM_COST an item, over the CTAs that share an SM.
    Every shape that `takes` accepts has one (an item of one position fits
    where the halo did)."""
    cp = _padded_width(ch)
    cl, most_ctas = FWD_GROUPS[cp]
    lanes = cp // cl
    tw = FWD_NQ * 32 // lanes
    (d, h, w), (kd, kh, kw) = dims, kernel
    cols = FWD_NQ - 1 + kw
    nc = FWD_NC[0] if cols <= FWD_NC[0] else FWD_NC[1]
    n_chunks = -(-cols // nc)
    n_rel = math.prod(2 * kk - 1 for kk in kernel)
    rpb_bytes = 4 * (-(-n_rel // 4) * 4) if has_bias else 0
    row_bytes = 2 * 2 * 4 * (cp + 4)  # K and V, two stages
    uw = min(tw, w) + kw - 1 if circular_w else _max_span(w, kw, tw, False, False)
    best, best_cost = None, None
    for td, th in FWD_ROWS:
        ud, uh = _max_span(d, kd, td, False, False), _max_span(h, kh, th, False, False)
        n_tiles = -(-d // td) * -(-h // th) * -(-w // tw)
        for ctas in range(most_ctas, 0, -1):
            budget = min(SMEM_LIMIT, SM_SMEM // ctas - 1024) - rpb_bytes
            item = _fwd_item(uh, uw, budget, row_bytes)
            if item is None:
                continue
            ry, rx = item
            items = ud * -(-uh // ry) * -(-uw // rx)
            rows = min(ry, kh) if ry < uh else kh  # the most a warp walks in an item
            cost = n_tiles * items * (rows * n_chunks + ITEM_COST) / ctas
            if best_cost is None or cost < best_cost:
                smem = rpb_bytes + row_bytes * ry * rx
                best = FwdPlan(cp, lanes, nc, td, th, tw, ry, rx, smem, ctas, n_tiles)
                best_cost = cost
    if best is None:
        raise ValueError(f"natten_flash: no K5a plan of volume {dims} x ch {ch} at kernel {kernel} "
                         f"fits {SMEM_LIMIT} bytes of shared memory")
    return best


def takes(shape, kernel, circular_w: bool, has_bias: bool, backward: bool = False) -> bool:
    """True when K5a (and, with `backward`, both kernels of K5b) take q of
    `shape` [B, D, H, W, heads, ch] at `kernel`; otherwise `_pick_tile`'s
    ValueError, which names the limit. A pure host function."""
    for kind in ("fwd", "dq", "dkv") if backward else ("fwd",):
        _pick_tile(kind, tuple(shape[1:4]), tuple(kernel), bool(circular_w), shape[-1],
                   bool(has_bias))
    return True


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _position_stride(t: torch.Tensor, name: str) -> int:
    """Floats between consecutive positions of t [B, D, H, W, heads, ch],
    whose [heads, ch] rows must be dense (views of a fused qkv qualify)."""
    heads, ch = t.shape[-2:]
    ps = t.stride(3)
    want = (t.shape[1] * t.shape[2] * t.shape[3] * ps, t.shape[2] * t.shape[3] * ps,
            t.shape[3] * ps, ps, ch, 1)
    if any(s != w and n > 1 for s, w, n in zip(t.stride(), want, t.shape)) or ps < heads * ch:
        raise ValueError(f"natten_flash: {name} must have dense [heads, ch] rows at one stride")
    return ps


def _layout(q, k, v, kernel, circular_w, tensors):
    """(shape, position strides in elements, kernel and circular_w as the C
    entries take them; vec4: 16-byte copies allowed, of four f32 or eight
    bf16 channels)."""
    ch, per16 = q.shape[-1], 16 // q.element_size()
    strides = [_position_stride(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    vec4 = int(ch % per16 == 0 and all(s % per16 == 0 for s in strides)
               and all(t.data_ptr() % 16 == 0 for t in tensors))
    return (*q.shape, *strides, *kernel, int(circular_w)), vec4


def _geometry(q, k, v, kernel, circular_w, tile, tensors):
    """K5b's geometry arguments, the stream last."""
    layout, vec4 = _layout(q, k, v, kernel, circular_w, tensors)
    return (*layout, tile.td, tile.th, tile.tw, tile.ud, tile.uh, tile.uw, vec4,
            q.shape[-1]**-0.5, torch.cuda.current_stream().cuda_stream)


def _check_err(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"natten_flash {what}: CUDA kernel launch failed (cudaError {err})")


def _forward_cuda(q, k, v, kernel, rpb, circular_w, with_lse):
    """K5a: out [B, D, H, W, heads, ch] in q's dtype, and lse [B, D, H, W,
    heads] (f32) when asked. bf16 q, k, v and rpb take K5a's bf16 mode
    (the f32 plan)."""
    global LAUNCHES, BF16_LAUNCHES
    rpb = None if rpb is None else rpb.contiguous()
    dims, ch = tuple(q.shape[1:4]), q.shape[-1]
    takes(q.shape, kernel, circular_w, rpb is not None)
    plan = _fwd_plan(dims, kernel, circular_w, ch, rpb is not None)
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    lse = torch.empty(q.shape[:-1], device=q.device) if with_lse else None
    layout, vec4 = _layout(q, k, v, kernel, circular_w, (q, k, v, out))
    entry = "gwt_natten_flash_forward_bf16" if bf16 else "gwt_natten_flash_forward"
    with torch.cuda.device(q.device):
        err = c_function("natten_flash", entry, _FWD_ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(rpb), out.data_ptr(), _ptr(lse),
            *layout, vec4, bf16_scale(ch) if bf16 else ch**-0.5, plan.cp, plan.lanes, plan.nc,
            plan.td, plan.th, plan.ry, plan.rx, torch.cuda.current_stream().cuda_stream,
        )
    _check_err(err, "forward")
    if bf16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out, lse


def launch_backward(mode, q, k, v, rpb, dout, lse, delta, grads, partial, kernel, circular_w,
                    out=None):
    """One K5b kernel on the card: mode `DQ` writes grads[0] (dq) and, with
    rpb, its drpb partials into `partial` ([B * n_tiles, heads, n_rel] of
    the dq tile); mode `DKV` writes grads[1] and grads[2] (dk, dv). rpb
    contiguous or None, dout dense, delta = rowsum(dO * out)
    [B, D, H, W, heads]. bf16 `DQ` takes `out` (the forward's, dense)
    instead: the kernel forms delta from it and writes it into `delta`."""
    global BWD_DQ_LAUNCHES, BWD_DKV_LAUNCHES, BF16_BWD_DQ_LAUNCHES, BF16_BWD_DKV_LAUNCHES
    dims, ch = tuple(q.shape[1:4]), q.shape[-1]
    bf16 = q.dtype == torch.bfloat16
    if bf16 and mode == DQ and out is None:
        raise ValueError("natten_flash backward: the bf16 dq kernel forms delta from the forward's out")
    extra, read = (), (q, k, v, dout, *grads)
    if mode == DKV and bf16:  # its own key tile, and the TPU query tile whose parts it rounds
        plan = dkv_bf16_plan(dims, tuple(kernel), bool(circular_w), q.shape[-2], ch, rpb is not None)
        tile, ry, extra = plan.tile, plan.ry, (plan.jth, plan.jtw, plan.ctas, None, None)
    else:
        tile = _pick_tile("dq" if mode == DQ else "dkv", dims, kernel, circular_w, ch, rpb is not None)
        ry = 0 if mode == DQ else _dkv_rows(tile, kernel, ch)
        if bf16:  # the dq kernel reads no TPU tile; it forms delta from out
            extra, read = (*dims[1:], 1, out.data_ptr(), delta.data_ptr()), (*read, out)
    geometry = _geometry(q, k, v, kernel, circular_w, tile, read)
    outs = (grads[0], None, None, partial) if mode == DQ else (None, grads[1], grads[2], None)
    entry = ("gwt_natten_flash_backward_bf16", _BWD16_ARGTYPES) if bf16 else (
        "gwt_natten_flash_backward", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = c_function("natten_flash_bwd", *entry)(
            mode, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(rpb), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(_ptr(t) for t in outs),
            *geometry[:-1], ry, *extra, geometry[-1],
        )
    _check_err(err, "backward (dq)" if mode == DQ else "backward (dk/dv)")
    if mode == DQ:
        if bf16:
            BF16_BWD_DQ_LAUNCHES += 1
        else:
            BWD_DQ_LAUNCHES += 1
    elif bf16:
        BF16_BWD_DKV_LAUNCHES += 1
    else:
        BWD_DKV_LAUNCHES += 1


def _backward_cuda(q, k, v, rpb, out, lse, dout, kernel, circular_w):
    """K5b: (dq, dk, dv, drpb) in q's dtype, drpb None without rpb (bf16:
    K5b's bf16 mode, delta from the bf16 out and drpb rounded once)."""
    rpb = None if rpb is None else rpb.contiguous()
    dout = dout.contiguous()
    bf16_out = None
    if q.dtype == torch.bfloat16:  # the dq kernel forms delta from the bf16 out
        bf16_out = out.contiguous()
        delta = torch.empty(q.shape[:-1], device=q.device)
    else:
        delta = (dout * out).sum(-1).contiguous()  # [B, D, H, W, heads]
    grads = tuple(torch.empty(q.shape, device=q.device, dtype=q.dtype) for _ in range(3))
    partial = None
    if rpb is not None:
        tile = _pick_tile("dq", tuple(q.shape[1:4]), kernel, circular_w, q.shape[-1], True)
        partial = torch.empty(q.shape[0] * tile.n_tiles, q.shape[-2], rpb[0].numel(), device=q.device)
    for mode in (DQ, DKV):
        launch_backward(mode, q, k, v, rpb, dout, lse, delta, grads, partial, kernel, circular_w,
                        out=bf16_out)
    drpb = partial.sum(0).reshape(rpb.shape).to(rpb.dtype) if rpb is not None else None
    return (*grads, drpb)


class Kernels(NamedTuple):
    """What `_NattenFlash` runs: `forward` and `backward` on CUDA tensors,
    `plain_forward` and `plain_backward` on CPU tensors. forward(q, k, v,
    kernel, rpb, circular_w) -> (out, lse, residual); backward(q, k, v, rpb,
    residual, lse, dout, kernel, circular_w) -> (dq, dk, dv, drpb), which
    forms delta = dO . residual (out itself, but for the slot path in
    bf16: ops/natten3d.py)."""

    forward: Callable
    backward: Callable
    plain_forward: Callable
    plain_backward: Callable


def _forward_for_grad(q, k, v, kernel, rpb, circular_w):
    out, lse = _forward_cuda(q, k, v, kernel, rpb, circular_w, with_lse=True)
    return out, lse, out


def _plain_forward_for_grad(q, k, v, kernel, rpb, circular_w):
    out, lse = flash_forward_reference(q, k, v, kernel, rpb, circular_w, with_lse=True)
    return out, lse, out


# K5a and K5b, and their plain versions.
KERNELS = Kernels(_forward_for_grad, _backward_cuda, _plain_forward_for_grad,
                  natten_flash_backward_reference)


class _NattenFlash(torch.autograd.Function):
    """The forward with lse, then the backward, of `kernels`: this module's
    KERNELS (K5a, K5b) or ops/natten3d.py's (K6, K6b). CPU tensors take
    their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, rpb, kernel, circular_w, kernels):
        fwd = kernels.plain_forward if q.device.type == "cpu" else kernels.forward
        out, lse, residual = fwd(q, k, v, kernel, rpb, circular_w)
        ctx.save_for_backward(q, k, v, rpb, residual, lse)
        ctx.kernel, ctx.circular_w, ctx.kernels = kernel, circular_w, kernels
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, rpb, residual, lse = ctx.saved_tensors
        kernels = ctx.kernels
        bwd = kernels.plain_backward if q.device.type == "cpu" else kernels.backward
        dq, dk, dv, drpb = bwd(q, k, v, rpb, residual, lse, dout, ctx.kernel, ctx.circular_w)
        return dq, dk, dv, drpb, None, None, None


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()
