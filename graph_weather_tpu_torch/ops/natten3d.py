"""The 3D neighborhood attention forward for the shapes K5a cannot tile: the
port of the Pallas kernel K6 (`_natten_fwd_impl`) of
graph_weather_tpu/ops/pallas/natten3d.py.

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
channels, and heads of 96 or 128 at kernel (5, 7, 7). `takes` names its
limits. There is no backward kernel yet (the JAX package differentiates the
XLA scan): a gradient through K6 on the card raises in the dispatcher
(ops/neighborhood_attention.py). Launch count: `LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from graph_weather_tpu_torch.ops._build import c_function
from graph_weather_tpu_torch.ops.natten_flash import SMEM_LIMIT, _position_stride, _ptr
from graph_weather_tpu_torch.ops.neighborhood_attention import (
    _check,
    neighborhood_attention_3d_reference,
)

LAUNCHES = 0  # K6
MAX_CHANNELS = 256  # widest head the kernel's tiles hold
TILE_WIDTHS = (32, 64, 96, 128, 256)  # the kernel's padded head widths (CP)
MAX_GRID_YZ = 65535  # heads and batch are the CTA grid's y and z
GRADIENT_TODO = (
    "neighborhood_attention_3d: no backward kernel for the slot-serial K6 yet "
    "(ROADMAP.md §2, 'K6b: the slot-serial backward'); pass impl=\"xla\" to "
    "differentiate the plain version"
)

_c_ptr, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (
    [_c_ptr] * 5  # q k v rpb out
    + [_c_int] * 6  # batch, D, H, W, heads, ch
    + [_c_ll] * 3  # position strides of q, k, v (in floats)
    + [_c_int] * 5  # kd, kh, kw, circular_w, vec4
    + [ctypes.c_float]  # scale
    + [_c_int] * 5  # cp, lanes, rows, ry, rx
    + [_c_ptr]  # cudaStream_t
)


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


def takes(shape, kernel, circular_w: bool, has_bias: bool) -> bool:
    """True when K6 takes q of `shape` [B, D, H, W, heads, ch] at `kernel`;
    otherwise ValueError naming the limit. A pure host function."""
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
    return True


def _forward_cuda(q, k, v, kernel, rpb, circular_w):
    """K6: out [B, D, H, W, heads, ch] (dense)."""
    global LAUNCHES
    takes(tuple(q.shape), kernel, circular_w, rpb is not None)
    rpb = None if rpb is None else rpb.contiguous()
    out = torch.empty(q.shape, device=q.device)
    b, d, h, w, heads, ch = q.shape
    strides = [_position_stride(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    vec4 = int(ch % 4 == 0 and all(s % 4 == 0 for s in strides)
               and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    tiles = plan(tuple(q.shape), kernel, circular_w)
    with torch.cuda.device(q.device):
        err = c_function("natten3d", "gwt_natten3d_forward", _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(rpb), out.data_ptr(),
            b, d, h, w, heads, ch, *strides, *kernel, int(circular_w), vec4, ch**-0.5,
            tiles.cp, tiles.lanes, tiles.rows, tiles.ry, tiles.rx,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"natten3d forward: CUDA kernel launch failed (cudaError {err})")
    LAUNCHES += 1
    return out


def neighborhood_attention_3d_slot(
    q: torch.Tensor,  # [B, D, H, W, heads, ch]
    k: torch.Tensor,
    v: torch.Tensor,
    kernel: tuple[int, int, int],
    rpb: torch.Tensor | None = None,  # [heads, 2kd-1, 2kh-1, 2kw-1]
    circular_w: bool = False,
) -> torch.Tensor:
    """Returns [B, D, H, W, heads, ch]. CUDA tensors launch K6 (ValueError
    for a shape it does not take, NotImplementedError when a gradient is
    asked for); CPU tensors take the plain version, which autograd
    differentiates."""
    kernel = tuple(int(kk) for kk in kernel)
    circular_w = bool(circular_w)
    _check(q, k, v, kernel, rpb, circular_w)
    if q.device.type == "cpu":
        return neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular_w)
    tensors = (q, k, v) if rpb is None else (q, k, v, rpb)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(GRADIENT_TODO)
    return _forward_cuda(q, k, v, kernel, rpb, circular_w)
