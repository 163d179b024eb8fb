"""The 3D neighborhood attention for the shapes K5a cannot tile: the port of
the Pallas kernel K6 (`_natten_fwd_impl`) of
graph_weather_tpu/ops/pallas/natten3d.py, and its backward K6b.

The semantics are those of ops/neighborhood_attention.py, and the plain
version is its `neighborhood_attention_3d_reference`: the JAX package's XLA
slot scan, the same function K6 computes. The TPU kernel walked the window
slots as a grid axis over VMEM-resident volumes; the CUDA kernel
(csrc/natten3d.cu) gives each CTA a tile of query positions in one D plane
and stages, one key plane (slab) at a time, the union of the tile's windows
in that plane in shared memory, K and V; groups of lanes own four
W-neighbouring queries each, so that every staged element feeds four
queries' FMAs. A slab is staged in strips where it does not fit (`plan`), so the
kernel takes what K5a (ops/natten_flash.py) refuses: heads wider than 128
channels, and heads of 96 or 128 at kernel (5, 7, 7). For training it also
writes lse.

The JAX package differentiates the XLA scan; the port's backward is K6b
(csrc/natten3d_bwd.cu), two kernels on K6's tiles and no atomics, joined
by a slot table of p and ds per (query, window slot, head) (`table_shape`):
dq over query tiles (K6's loop with ds = p (dO.v - dO.out) in place of p,
storing each in-window pair's p and ds at its slot, and per CTA the sums of
ds per relative offset, [n_cta, heads, n_rel], which one torch sum turns
into drpb), and dk/dv over key tiles, each CTA staging per query plane the
union of its keys' inverse windows (q and dO rows) and reading each pair's
p and ds from the table. `plan_backward` picks both kernels' tiles and
counts the table's bytes; `takes(..., backward=True)` names the limits of
both. Its plain version is
ops/natten_flash.py's `natten_flash_backward_reference`. Under autograd
natten_flash's `_NattenFlash` runs this module's KERNELS (K6 with lse,
then K6b). Launch counts: `LAUNCHES`
(K6), `BWD_DQ_LAUNCHES` and `BWD_DKV_LAUNCHES` (K6b's two kernels).

bf16 q, k, v and rpb take the kernels' bf16 modes (the JAX package's bf16
slot scan, as XLA computes it on the CPU; the plain versions `slot_forward`
and `slot_backward_reference`): K6·bf16 also writes out32, its f32 result,
from which K6b·bf16 forms delta; K6b·bf16 is the dq kernel on bf16 loads, a
dk/dv kernel in the scan's reverse slot order and two drpb kernels
(`launch_backward_bf16`; counts `BF16_LAUNCHES`, `BF16_BWD_DQ_LAUNCHES`,
`BF16_BWD_DKV_LAUNCHES`, `BF16_DRPB_SLOT_LAUNCHES`, `BF16_DRPB_LAUNCHES`).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from graph_weather_tpu_torch.ops._build import c_function
from graph_weather_tpu_torch.ops.natten_flash import (
    SMEM_LIMIT,
    Kernels,
    _max_span,
    _NattenFlash,
    _ptr,
    natten_flash_backward_reference,
)
from graph_weather_tpu_torch.ops.natten_flash import _layout as _flash_layout
from graph_weather_tpu_torch.ops.neighborhood_attention import (
    _check,
    _gather,
    _slot_bias,
    _slot_tables,
    _slots,
    bf16_scale,
    neighborhood_attention_3d_reference,
    ordered_scatter_bf16,
    round_bf16,
    scaled_q,
    slot_forward,
)

LAUNCHES = 0  # K6
BWD_DQ_LAUNCHES = 0  # K6b, dq and drpb partials
BWD_DKV_LAUNCHES = 0  # K6b, dk and dv
BF16_LAUNCHES = 0  # K6 in bf16
BF16_BWD_DQ_LAUNCHES = 0  # K6b in bf16: dq and the slot table
BF16_BWD_DKV_LAUNCHES = 0  # K6b in bf16: dk and dv in the slot scan's order
BF16_DRPB_SLOT_LAUNCHES = 0  # K6b in bf16: each slot's drpb sums
BF16_DRPB_LAUNCHES = 0  # K6b in bf16: drpb over the slots
MAX_CHANNELS = 256  # widest head the kernel's tiles hold
TILE_WIDTHS = (32, 64, 96, 128, 256)  # the kernel's padded head widths (CP)
MAX_GRID_YZ = 65535  # heads and batch are the CTA grid's y and z
DQ, DKV = 0, 1  # backward modes of the C entry (K6b's two kernels)
DRPB_SLOTS, DRPB = 2, 3  # and the bf16 entry's drpb kernels
BWD_NQ, BWD_NK = 4, 2  # W-neighbouring queries (dq) and keys (dk/dv) of a lane group
# CTAs an SM the dk/dv kernel is built for (DKV_CTAS), each with that share of
# the SM's shared memory: 233,472 bytes on Hopper, 1 KB of it reserved per CTA
BWD_DKV_CTAS, SM_SMEM = 2, 233472

_c_ptr, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (
    [_c_ptr] * 6  # q k v rpb out lse
    + [_c_int] * 6  # batch, D, H, W, heads, ch
    + [_c_ll] * 3  # position strides of q, k, v (in floats)
    + [_c_int] * 5  # kd, kh, kw, circular_w, vec4
    + [ctypes.c_float]  # scale
    + [_c_int] * 5  # cp, lanes, rows, ry, rx
    + [_c_ptr]  # cudaStream_t
)
# mode, q k v rpb dout lse out dq dk dv partial table, then as the forward
# from batch on
_BWD_ARGTYPES = [_c_int] + [_c_ptr] * 12 + _ARGTYPES[6:]
# bf16: q k v rpb out lse out32, then as the forward; the backward's mode, q k
# v rpb dout lse out32 dq dk dv table work drpb, then as the forward
_FWD16_ARGTYPES = [_c_ptr] * 7 + _ARGTYPES[6:]
_BWD16_ARGTYPES = [_c_int] + [_c_ptr] * 13 + _ARGTYPES[6:]


@dataclass(frozen=True)
class Plan:
    """A launch of the kernel: padded head width `cp`, `lanes` lanes to a
    group of four W-neighbouring queries (so 128 / lanes query columns to a
    CTA), `rows` query rows to a CTA (one warp each), items of ry union rows
    by rx union columns, and the shared memory it takes."""

    cp: int
    lanes: int
    rows: int
    ry: int
    rx: int
    smem: int

    @property
    def columns(self) -> int:
        return 4 * 32 // self.lanes


def union_span(size: int, k: int, circular: bool, t: int) -> int:
    """The most positions the union of the windows of t consecutive queries
    spans on an axis of `size` (window k): t + k - 1, at most `size` on a
    clamped axis (its windows stay inside it)."""
    span = min(t, size) + k - 1
    return span if circular else min(size, span)


def plan(shape, kernel, circular_w: bool) -> Plan:
    """How the kernel tiles q of `shape` [B, D, H, W, heads, ch] at `kernel`:
    eight lanes to a query group up to 96 channels (each lane 4 to 12 of
    them), sixteen above; up to 8 query rows to a CTA; items as tall as two
    stages of K and V allow in Hopper's 227 KB (the whole union where it
    fits), of equal heights. A pure host function."""
    _, _, h, w, _, ch = shape
    _, kh, kw = kernel
    cp = next(c for c in TILE_WIDTHS if ch <= c)
    lanes = 8 if cp <= 96 else 16
    rows = min(8, h)
    cu_h = union_span(h, kh, False, rows)
    cu_w = union_span(w, kw, circular_w, 4 * 32 // lanes)
    per_row = 2 * 2 * 4 * (cp + 4)  # bytes of a staged row: K and V, two stages
    most = SMEM_LIMIT // per_row  # staged rows an item may hold
    rx = min(cu_w, most)
    ry = min(cu_h, most // rx)
    ry = -(-cu_h // -(-cu_h // ry))  # equal strips
    return Plan(cp, lanes, rows, ry, rx, per_row * ry * rx)


@dataclass(frozen=True)
class BwdPlan:
    """A launch of one K6b kernel: padded head width `cp`, `lanes` lanes to a
    group (of BWD_NQ queries in the dq kernel, BWD_NK keys in the dk/dv
    kernel), `rows` rows (one warp each) by `columns` W positions a CTA,
    items of ry union rows by rx union columns of a plane, the shared memory
    it takes, the CTAs over the volume of one batch entry, and the bytes of
    the slot table that the dq kernel writes and the dk/dv kernel reads."""

    cp: int
    lanes: int
    rows: int
    columns: int
    ry: int
    rx: int
    smem: int
    n_tiles: int
    table: int


def table_shape(shape, kernel) -> tuple[int, ...]:
    """K6b's slot table for q of `shape` [B, D, H, W, heads, ch] at `kernel`:
    [B, D, H, W, heads, kd, kh * kw rounded up to even, 2], (p, ds) of each
    query's window slot (x, y * kw + z), f32, query-major
    (csrc/natten3d_bwd.cu, `table_at`); the pad after a key plane's slots
    (odd kh * kw) keeps each plane on 16 bytes and is never written or
    read."""
    kd, kh, kw = kernel
    return (*shape[:5], kd, kh * kw + kh * kw % 2, 2)


def _bwd_lanes(cp: int) -> int:
    """K6b's lanes to a group: eight up to 96 channels, cp / 8 above (eight
    channels a lane, so that q, dO and the sums of a group's positions stay
    in registers)."""
    return 8 if cp <= 96 else cp // 8


def _strips(span: int, most: int) -> int:
    """The largest strip of at most `most` positions that cuts `span` into
    pieces of equal size."""
    most = min(span, most)
    return -(-span // -(-span // most))


def plan_backward(shape, kernel, circular_w: bool, has_bias: bool) -> tuple[BwdPlan, BwdPlan]:
    """How K6b tiles q of `shape` [B, D, H, W, heads, ch] at `kernel`: (the
    dq kernel's plan, the dk/dv kernel's), indexed by DQ and DKV. A pure host
    function, called before any launch; ValueError where no tile fits.

    dq: K6's tile (up to 8 query rows of 128 / lanes columns), two stages of
    K and V items of the windows' union, and with rpb the CTA's ds per
    (query, slot of a slab) and per-axis slot tables; the most rows whose
    table leaves room for one staged position. dk/dv: up to 8 key rows of
    BWD_NK * 32 / lanes columns, two stages of items of the keys' inverse
    windows (q and dO rows, and each position's slots of the key plane from
    the table), within 1 / BWD_DKV_CTAS of an SM, or within 227 KB where
    one position does not fit that. Both: the slot table's bytes
    (`table_shape`), in device memory."""
    _, d, h, w, _, ch = shape
    _, kh, kw = kernel
    cp = next(c for c in TILE_WIDTHS if ch <= c)
    lanes = _bwd_lanes(cp)
    columns = BWD_NQ * 32 // lanes
    table_bytes = 4 * math.prod(table_shape(shape, kernel))
    per_row = 2 * 2 * 4 * (cp + 4)  # bytes of a staged position: K and V, two stages
    dq = None
    for rows in range(min(8, h), 0, -1):
        table = 0
        if has_bias:
            table = 4 * rows * columns * kh * kw + (2 * kh - 1) * rows + (2 * kw - 1) * columns
        most = (SMEM_LIMIT - table) // per_row
        if most < 1:
            continue
        cu_h, cu_w = union_span(h, kh, False, rows), union_span(w, kw, circular_w, columns)
        rx = _strips(cu_w, most)
        ry = _strips(cu_h, most // rx)
        dq = BwdPlan(cp, lanes, rows, columns, ry, rx, per_row * ry * rx + table,
                     d * -(-h // rows) * -(-w // columns), table_bytes)
        break
    if dq is None:
        raise ValueError(f"natten3d: no backward tile of kernel {tuple(kernel)} x ch {ch} fits "
                         f"{SMEM_LIMIT} bytes of shared memory (the dq kernel's ds per slot)")
    rows, columns = min(8, h), BWD_NK * 32 // lanes
    cu_h = _max_span(h, kh, rows, False, True)
    cu_w = min(columns, w) + kw - 1 if circular_w else _max_span(w, kw, columns, False, True)
    slots = table_shape(shape, kernel)[-2]
    position = 2 * 4 * (2 * (cp + 4) + 2 * slots)  # q and dO rows, (p, ds) per slot; two stages
    most = min(SMEM_LIMIT, SM_SMEM // BWD_DKV_CTAS - 1024) // position
    if most < 1:  # a window too wide for BWD_DKV_CTAS CTAs an SM: one CTA an SM
        most = SMEM_LIMIT // position
    if most < 1:
        raise ValueError(f"natten3d: no backward tile of kernel {tuple(kernel)} x ch {ch} fits "
                         f"{SMEM_LIMIT} bytes of shared memory (the dk/dv kernel's staged "
                         f"slots of one query)")
    rx = _strips(cu_w, most)
    ry = _strips(cu_h, most // rx)
    dkv = BwdPlan(cp, lanes, rows, columns, ry, rx, position * ry * rx,
                  d * -(-h // rows) * -(-w // columns), table_bytes)
    return dq, dkv


def takes(shape, kernel, circular_w: bool, has_bias: bool, backward: bool = False) -> bool:
    """True when K6 (and, with `backward`, both kernels of K6b) take q of
    `shape` [B, D, H, W, heads, ch] at `kernel`; otherwise ValueError naming
    the limit. A pure host function."""
    b, d, h, w, heads, ch = shape
    if ch > MAX_CHANNELS:
        raise ValueError(f"natten3d: head width {ch} > {MAX_CHANNELS}")
    if b > MAX_GRID_YZ or heads > MAX_GRID_YZ:
        raise ValueError(f"natten3d: batch {b} and heads {heads} must be <= {MAX_GRID_YZ}")
    for size, kk in zip((d, h, w), kernel):
        if kk > size:
            raise ValueError(f"natten3d: kernel {tuple(kernel)} exceeds the volume {(d, h, w)}")
    n_rel = math.prod(2 * kk - 1 for kk in kernel)  # rpb is read through L1, at most
    if has_bias and 4 * n_rel > SMEM_LIMIT:  # 227 KB of it per head
        raise ValueError(f"natten3d: rpb of {n_rel} floats per head exceeds {SMEM_LIMIT} bytes "
                         "of shared memory")
    if backward:
        plan_backward(shape, kernel, circular_w, has_bias)
    return True


def _layout(q, k, v, kernel, circular_w, tensors):
    """The C entries' arguments from batch to scale (K5a's, and scale)."""
    layout, vec4 = _flash_layout(q, k, v, kernel, circular_w, tensors)
    return (*layout, vec4, q.shape[-1] ** -0.5)


def _check_err(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"natten3d {what}: CUDA kernel launch failed (cudaError {err})")


def _forward_cuda(q, k, v, kernel, rpb, circular_w, with_lse=False, out32=None):
    """K6: out [B, D, H, W, heads, ch] (dense, q's dtype), and lse [B, D, H,
    W, heads] (f32) when asked (else None). bf16 q, k, v and rpb take K6's
    bf16 mode (the f32 plan), which also writes `out32` (f32, dense: out
    before its rounding) when given."""
    global LAUNCHES, BF16_LAUNCHES
    takes(tuple(q.shape), kernel, circular_w, rpb is not None)
    rpb = None if rpb is None else rpb.contiguous()
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    lse = torch.empty(q.shape[:-1], device=q.device) if with_lse else None
    tiles = plan(tuple(q.shape), kernel, circular_w)
    layout = _layout(q, k, v, kernel, circular_w, (q, k, v, out))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(rpb), out.data_ptr(), _ptr(lse))
    args = (*_tiles_args(tiles), torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(q.device):
        if bf16:
            err = c_function("natten3d", "gwt_natten3d_forward_bf16", _FWD16_ARGTYPES)(
                *ptrs, _ptr(out32), *layout[:-1], bf16_scale(q.shape[-1]), *args)
        else:
            err = c_function("natten3d", "gwt_natten3d_forward", _ARGTYPES)(*ptrs, *layout, *args)
    _check_err(err, "forward")
    if bf16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out, lse


def _tiles_args(tiles) -> tuple[int, ...]:
    """A plan's arguments to the C entries: cp, lanes, rows, ry, rx."""
    return tiles.cp, tiles.lanes, tiles.rows, tiles.ry, tiles.rx


def launch_backward(mode, q, k, v, rpb, dout, lse, out, grads, partial, table, kernel,
                    circular_w):
    """One K6b kernel on the card: mode `DQ` writes grads[0] (dq), every
    slot of `table` (`table_shape`, contiguous f32) and, with rpb, its drpb
    partials into `partial` ([B * n_tiles, heads, n_rel] of the dq plan);
    mode `DKV` writes grads[1] and grads[2] (dk, dv) from q, dout and the
    table the dq kernel wrote. rpb contiguous or None; dout and K6's out
    dense (the dq kernel forms delta = rowsum(dO * out) itself)."""
    global BWD_DQ_LAUNCHES, BWD_DKV_LAUNCHES
    if q.dtype == torch.bfloat16:
        raise TypeError("natten3d backward: bf16 tensors take launch_backward_bf16")
    if (table.shape != table_shape(q.shape, kernel) or table.dtype != torch.float32
            or not table.is_contiguous() or table.device != q.device):
        raise ValueError(f"natten3d backward: the slot table must be a contiguous f32 "
                         f"{table_shape(q.shape, kernel)} on {q.device}")
    tiles = plan_backward(tuple(q.shape), kernel, circular_w, rpb is not None)[mode]
    outs = (grads[0], None, None, partial) if mode == DQ else (None, grads[1], grads[2], None)
    layout = _layout(q, k, v, kernel, circular_w, [q, k, v, dout, *(t for t in outs[:3] if t is not None)])
    with torch.cuda.device(q.device):
        err = c_function("natten3d_bwd", "gwt_natten3d_backward", _BWD_ARGTYPES)(
            mode, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(rpb), dout.data_ptr(),
            lse.data_ptr(), out.data_ptr(), *(_ptr(t) for t in outs), table.data_ptr(), *layout,
            tiles.cp, tiles.lanes, tiles.rows, tiles.ry, tiles.rx,
            torch.cuda.current_stream().cuda_stream,
        )
    _check_err(err, "backward (dq)" if mode == DQ else "backward (dk/dv)")
    if mode == DQ:
        BWD_DQ_LAUNCHES += 1
    else:
        BWD_DKV_LAUNCHES += 1


def work_floats(shape, kernel) -> int:
    """Floats of the bf16 drpb kernels' work buffer for q of `shape`: per
    (head, slot) the sums after the W, H and D transposes."""
    _, d, h, _, heads, _ = shape
    nrd, nrh, nrw = (2 * kk - 1 for kk in kernel)
    return heads * math.prod(kernel) * (d * h * nrw + d * nrh * nrw + nrd * nrh * nrw)


def launch_backward_bf16(mode, q, k, v, rpb, dout, lse, out32, grads, table, work, drpb, kernel,
                         circular_w):
    """One kernel of K6b's bf16 mode on the card (bf16 q, k, v, rpb, dout and
    grads; f32 lse, out32, table and work): mode `DQ` writes grads[0] (dq)
    and the slot table, `DKV` grads[1] and grads[2] (dk, dv) from the table,
    `DRPB_SLOTS` each slot's drpb sums into `work` (`work_floats`), `DRPB`
    drpb (bf16, rpb's shape) from work."""
    global BF16_BWD_DQ_LAUNCHES, BF16_BWD_DKV_LAUNCHES, BF16_DRPB_SLOT_LAUNCHES, BF16_DRPB_LAUNCHES
    if (table.shape != table_shape(q.shape, kernel) or table.dtype != torch.float32
            or not table.is_contiguous() or table.device != q.device):
        raise ValueError(f"natten3d backward: the slot table must be a contiguous f32 "
                         f"{table_shape(q.shape, kernel)} on {q.device}")
    if mode in (DRPB_SLOTS, DRPB) and (rpb is None or work is None
                                       or work.numel() < work_floats(q.shape, kernel)):
        raise ValueError("natten3d backward: the drpb kernels take rpb and a work buffer of "
                         "work_floats(shape, kernel) floats")
    tiles = plan_backward(tuple(q.shape), kernel, circular_w, rpb is not None)[DQ]
    layout = _layout(q, k, v, kernel, circular_w, [q, k, v, dout, *grads])
    with torch.cuda.device(q.device):
        err = c_function("natten3d_bwd", "gwt_natten3d_backward_bf16", _BWD16_ARGTYPES)(
            mode, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(rpb), dout.data_ptr(),
            lse.data_ptr(), out32.data_ptr(), *(_ptr(t) for t in grads), table.data_ptr(),
            _ptr(work), _ptr(drpb), *layout[:-1], bf16_scale(q.shape[-1]), *_tiles_args(tiles),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_err(err, ("backward (dq)", "backward (dk/dv)", "backward (drpb slots)",
                     "backward (drpb)")[mode])
    if mode == DQ:
        BF16_BWD_DQ_LAUNCHES += 1
    elif mode == DKV:
        BF16_BWD_DKV_LAUNCHES += 1
    elif mode == DRPB_SLOTS:
        BF16_DRPB_SLOT_LAUNCHES += 1
    else:
        BF16_DRPB_LAUNCHES += 1


def _backward_cuda(q, k, v, rpb, out, lse, dout, kernel, circular_w):
    """K6b: (dq, dk, dv, drpb) in q's dtype, drpb None without rpb. The slot
    table lives for this call only. On bf16 tensors K6b's bf16 mode, whose
    `out` is K6's out32."""
    rpb = None if rpb is None else rpb.contiguous()
    if q.dtype == torch.bfloat16:
        dout, out = dout.contiguous(), out.contiguous()
        grads = tuple(torch.empty(q.shape, device=q.device, dtype=q.dtype) for _ in range(3))
        table = torch.empty(table_shape(q.shape, kernel), device=q.device)
        work = drpb = None
        if rpb is not None:
            work = torch.empty(work_floats(q.shape, kernel), device=q.device)
            drpb = torch.empty(rpb.shape, device=q.device, dtype=rpb.dtype)
        for mode in (DQ, DKV) + ((DRPB_SLOTS, DRPB) if rpb is not None else ()):
            launch_backward_bf16(mode, q, k, v, rpb, dout, lse, out, grads, table, work, drpb,
                                 kernel, circular_w)
        return (*grads, drpb)
    dout = dout.contiguous()
    out = out.contiguous()
    grads = tuple(torch.empty(q.shape, device=q.device) for _ in range(3))
    partial = None
    if rpb is not None:
        tiles = plan_backward(tuple(q.shape), kernel, circular_w, True)[DQ]
        partial = torch.empty(q.shape[0] * tiles.n_tiles, q.shape[-2], rpb[0].numel(),
                              device=q.device)
    table = torch.empty(table_shape(q.shape, kernel), device=q.device)
    for mode in (DQ, DKV):
        launch_backward(mode, q, k, v, rpb, dout, lse, out, grads, partial, table, kernel,
                        circular_w)
    drpb = partial.sum(0).reshape(rpb.shape) if rpb is not None else None
    return (*grads, drpb)


def _scatter_slot_bf16(src, tables, slot):
    """The transposes of the slot's per-axis takes (W, then H, then D) of
    src [B, D, H, W, ...] bf16 values, each an ordered bf16 scatter."""
    for axis in (3, 2, 1):
        idx = tables[axis - 1][0][:, slot[axis - 1]]
        src = ordered_scatter_bf16(src, axis, idx, src.shape[axis])
    return src


def _scatter_bias_bf16(ds, tables, slot, rpb_shape):
    """The transposes of the slot's per-axis bias gathers (W, then H, then D)
    of ds [heads, D, H, W] bf16 values into [heads, 2kd-1, 2kh-1, 2kw-1]."""
    for axis in (3, 2, 1):
        rel = tables[axis - 1][1][:, slot[axis - 1]]
        ds = ordered_scatter_bf16(ds, axis, rel, rpb_shape[axis])
    return ds


def slot_backward_reference(q, k, v, rpb, out32, lse, dout, kernel, circular_w=False):
    """Plain PyTorch version of K6b: (dq, dk, dv, drpb), drpb None without
    rpb. On f32 tensors ops/natten_flash.py's `natten_flash_backward_reference`
    (the same function). On bf16 the gradient of the JAX package's bf16 slot
    scan as XLA computes it: delta = dO . out32 (the scan's f32 result
    before its rounding); per slot, in reverse slot order, p and ds in f32,
    dq's f32 sum of ds k; each (query, slot) pair's ds q-hat and p dO rounded
    to bf16 and scattered back by the transposes of the slot's three takes
    (W, then H, then D: `ordered_scatter_bf16`), whose sum is added into
    each key's bf16 running sum; drpb likewise from bf16(sum over the batch
    of ds) through the bias gathers' transposes; dq = bf16(bf16(sum) x
    bf16(ch^-0.5)) (its f32 sum is rounded, then scaled in bf16)."""
    if q.dtype != torch.bfloat16:
        return natten_flash_backward_reference(q, k, v, rpb, out32, lse, dout, kernel, circular_w)
    tables = _slot_tables(q.shape, kernel, circular_w, q.device)
    qs = scaled_q(q)
    g = dout.float()
    ch = q.shape[-1]
    delta = (g * out32).sum(-1)
    dq = torch.zeros(q.shape, device=q.device)
    dk, dv = torch.zeros(q.shape, device=q.device), torch.zeros(q.shape, device=q.device)
    drpb = None if rpb is None else torch.zeros(rpb.shape, device=q.device)
    for slot in reversed(_slots(kernel)):
        ks, vs = _gather(k, tables, slot).float(), _gather(v, tables, slot).float()
        s = (qs * ks).sum(-1)
        if rpb is not None:
            s = s + _slot_bias(rpb, tables, slot).float()
        p = torch.exp(s - lse)
        ds = p * ((g * vs).sum(-1) - delta)
        dq += ds[..., None] * ks
        both = torch.cat([ds[..., None] * qs, p[..., None] * g], -1)  # dk's and dv's pairs
        both = _scatter_slot_bf16(round_bf16(both), tables, slot)
        dk = round_bf16(dk + both[..., :ch])
        dv = round_bf16(dv + both[..., ch:])
        if rpb is not None:
            ds_b = round_bf16(ds.sum(0)).permute(3, 0, 1, 2)  # [heads, D, H, W]
            drpb = round_bf16(drpb + _scatter_bias_bf16(ds_b, tables, slot, rpb.shape))
    dq = round_bf16(round_bf16(dq) * bf16_scale(q.shape[-1]))
    bf16 = torch.bfloat16
    return dq.to(bf16), dk.to(bf16), dv.to(bf16), None if drpb is None else drpb.to(bf16)


def _forward_for_grad(q, k, v, kernel, rpb, circular_w):
    """K6 with lse, and the tensor its backward forms delta from: out, or in
    bf16 out32 (the slot scan differentiates its f32 result)."""
    if q.dtype != torch.bfloat16:
        out, lse = _forward_cuda(q, k, v, kernel, rpb, circular_w, with_lse=True)
        return out, lse, out
    out32 = torch.empty(q.shape, device=q.device)
    out, lse = _forward_cuda(q, k, v, kernel, rpb, circular_w, with_lse=True, out32=out32)
    return out, lse, out32


# K6 and K6b, and their plain versions (the slot scan).
KERNELS = Kernels(_forward_for_grad, _backward_cuda, slot_forward, slot_backward_reference)


def neighborhood_attention_3d_slot(
    q: torch.Tensor,  # [B, D, H, W, heads, ch]
    k: torch.Tensor,
    v: torch.Tensor,
    kernel: tuple[int, int, int],
    rpb: torch.Tensor | None = None,  # [heads, 2kd-1, 2kh-1, 2kw-1]
    circular_w: bool = False,
) -> torch.Tensor:
    """Returns [B, D, H, W, heads, ch]. CUDA tensors launch K6, and K6b under
    a gradient (ValueError for a shape they do not take); CPU tensors take
    the plain version, which autograd differentiates in f32 (in bf16 the
    plain backward, `slot_backward_reference`)."""
    kernel = tuple(int(kk) for kk in kernel)
    circular_w = bool(circular_w)
    _check(q, k, v, kernel, rpb, circular_w)
    tensors = (q, k, v) if rpb is None else (q, k, v, rpb)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if q.device.type == "cpu":
        if needs_grad and q.dtype == torch.bfloat16:
            return _NattenFlash.apply(q, k, v, rpb, kernel, circular_w, KERNELS)
        return neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular_w)
    if needs_grad:
        takes(tuple(q.shape), kernel, circular_w, rpb is not None, backward=True)
        return _NattenFlash.apply(q, k, v, rpb, kernel, circular_w, KERNELS)
    return _forward_cuda(q, k, v, kernel, rpb, circular_w)[0]
