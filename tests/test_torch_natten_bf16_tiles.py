"""The walk of K5b·bf16's dk/dv kernel (csrc/natten_flash_bwd.cu,
`natten_dkv_bf16_kernel`), on the CPU, against the TPU kernel's rounding
of dk and dv per query tile (`_TileParts`).

The TPU kernel rounds each key's dk and dv to bf16 once per query tile (all
of D by th x tw of H and W, `tpu_backward_tile`) and adds those parts in
f32; the plain backward (`natten_flash_backward_reference`) does so through
`_TileParts`. The CUDA kernel gives each warp a patch of 4 x 4 keys of one
plane and walks its CTA's items (`dkv_bf16_items`: rows of the inverse
window, cut where a TPU tile of H ends, and the columns whose parts it
walks); in each item a warp walks its columns one TPU tile of W at a time
(`dkv_bf16_segments`), each the box of one part (its planes x the item's
rows of its window x the tile's columns), and closes the part at the end of
the box where the item ends a tile of H. `kernel_parts` below follows that
walk from the host's plan (`dkv_bf16_plan`), patch by patch, and the tests
check that every (query, key) pair of every window is visited once, and
that each key's parts, in the order the kernel closes them, are
`_TileParts`'s in the order of its sums, on the card tests' shapes, with the
planned items and with items of one row (the walk where a tile of H's rows
do not fit). Pure host code, no JAX.
"""

import dataclasses
import itertools

import pytest

from graph_weather_tpu_torch.ops import natten_flash
from graph_weather_tpu_torch.ops.natten_flash import (
    DKV16_PATCH,
    _TileParts,
    _inverse_span,
    dkv16_tile_plan,
    dkv_bf16_items,
    dkv_bf16_plan,
    dkv_bf16_segments,
    tpu_backward_tile,
)
from graph_weather_tpu_torch.ops.neighborhood_attention import _slot_tables

# (D, H, W), heads, ch, kernel, circular_w: tests/test_torch_kernels_cuda.py's
# NATTEN_BF16_CASES (the 1-degree layer cropped to 14 x 12 x 24 here), with
# its cases for key tiles that end inside a TPU tile, parts across the
# circular seam and a shape with no TPU tile.
SHAPES = [
    ((14, 12, 24), 4, 32, (3, 5, 5), False),
    ((5, 9, 11), 2, 32, (3, 3, 5), True),
    ((6, 9, 14), 8, 32, (5, 7, 7), False),
    ((4, 7, 9), 3, 12, (3, 3, 3), False),
    ((4, 15, 26), 4, 32, (3, 5, 5), False),
    ((3, 8, 22), 4, 32, (3, 3, 7), True),
    ((8, 16, 24), 8, 16, (3, 7, 7), False),
]
IDS = ["wm_crop", "circular_b2", "k577", "ch12", "tiles_inside", "circular_seam", "no_tpu_tile"]


def _window_start(i, size, k):
    return min(max(i - k // 2, 0), size - k)


def _inverse_lo(j, size, k, circular):
    return j - (k - 1 - k // 2) if circular or j >= k else 0


def _inverse_hi(j, size, k, circular):
    return j + k // 2 if circular or j < size - k else size - 1


def kernel_parts(dims, kernel, circular, plan):
    """{key (d, h, w): [part, ...]}, each part the list of its queries (d,
    h, w) in the order the kernel visits them, the parts in the order it
    closes them (empty parts dropped), following `natten_dkv_bf16_kernel`:
    key tiles of the plan, their items, patches of DKV16_PATCH keys, each
    patch's planes, the item's rows of its window and its columns by TPU
    tile of W; a key's pair is a query whose window holds it."""
    (d, h, w), (kd, kh, kw), t = dims, kernel, plan.tile
    ph, pw = DKV16_PATCH
    out = {}
    for d0, h0, w0 in itertools.product(range(0, d, t.td), range(0, h, t.th), range(0, w, t.tw)):
        lo_h, sp_h = _inverse_span(h0, min(h0 + t.th, h), h, kh, False)
        qc_lo = _inverse_lo(w0, w, kw, circular)
        qc_end = _inverse_hi(min(w0 + t.tw, w) - 1, w, kw, circular) + 1
        items = dkv_bf16_items(lo_h, sp_h, qc_lo, qc_end, w, plan.jth, plan.jtw, plan.ry)
        for pd, jh0, jw0 in itertools.product(range(t.td), range(h0, h0 + t.th, ph),
                                              range(w0, w0 + t.tw, pw)):
            jd = d0 + pd
            if jd >= d or jh0 >= h or jw0 >= w:
                continue
            planes = range(_inverse_lo(jd, d, kd, False), _inverse_hi(jd, d, kd, False) + 1)
            qh_lo = _inverse_lo(jh0, h, kh, False)
            qh_hi = _inverse_hi(min(jh0 + ph, h) - 1, h, kh, False)
            wc_lo = _inverse_lo(jw0, w, kw, circular)
            wc_end = _inverse_hi(min(jw0 + pw, w) - 1, w, kw, circular) + 1
            keys = list(itertools.product(range(jh0, min(jh0 + ph, h)), range(jw0, min(jw0 + pw, w))))
            parts = {key: [] for key in keys}
            part = {key: [] for key in keys}
            # each key's rows and (unreduced) columns among its patch's queries
            # whose window holds it
            hold = {(jh, jw): ([qh for qh in range(qh_lo, qh_hi + 1)
                                if 0 <= jh - _window_start(qh, h, kh) < kh],
                               [c for c in range(wc_lo, wc_end)
                                if 0 <= jw - (c - kw // 2 if circular else _window_start(c, w, kw)) < kw])
                    for jh, jw in keys}
            for y0, y1, c0, c1, closes in items:
                rows = range(max(y0, qh_lo), min(y1, qh_hi + 1))
                for s0, s1 in dkv_bf16_segments(max(c0, wc_lo), min(c1, wc_end), w, plan.jtw):
                    for key in keys:
                        key_rows, key_cols = hold[key]
                        part[key] += [(qd, qh, col % w) for qd in planes for qh in rows if qh in key_rows
                                      for col in range(s0, s1) if col in key_cols]
                    if closes:
                        for key in keys:
                            parts[key].append(part[key])
                            part[key] = []
            for key in keys:
                assert not part[key], "a part left open at the end of the walk"
                out[(jd, *key)] = [p for p in parts[key] if p]
    return out


def tile_parts(dims, heads, ch, kernel, circular):
    """{key: [part, ...]}: each key's queries grouped by `_TileParts`'s part
    index (the TPU query tile of the query, counted from the tile of the
    key's first query), in the order `_TileParts.sums` adds them."""
    (d, h, w), (kd, kh, kw) = dims, kernel
    shape = (1, d, h, w, heads, ch)
    tp = _TileParts(shape, kernel, circular, True, _slot_tables(shape, kernel, circular, "cpu"))
    tile_h, base_h, tile_w, base_w = (t.tolist() for t in (tp.tile_h, tp.base_h, tp.tile_w, tp.base_w))
    out = {}
    for qd, qh, qw in itertools.product(range(d), range(h), range(w)):
        sd, sh = _window_start(qd, d, kd), _window_start(qh, h, kh)
        cols = ([(qw - kw // 2 + z) % w for z in range(kw)] if circular
                else range(_window_start(qw, w, kw), _window_start(qw, w, kw) + kw))
        for jd, jh, jw in itertools.product(range(sd, sd + kd), range(sh, sh + kh), cols):
            part = (tile_h[qh] - base_h[jh]) * tp.nw + (tile_w[qw] - base_w[jw]) % tp.n_tw
            out.setdefault((jd, jh, jw), {}).setdefault(part, []).append((qd, qh, qw))
    return {key: [parts[i] for i in sorted(parts)] for key, parts in out.items()}


@pytest.mark.parametrize("one_row", [False, True], ids=["planned", "one_row_items"])
@pytest.mark.parametrize("case", SHAPES, ids=IDS)
def test_dkv_bf16_walk_gives_the_tpu_parts(case, one_row):
    """Every key's pairs visited once, in the parts of `_TileParts` and in
    its order, along the kernel's walk of the host's plan (and of the same
    plan with items of one row)."""
    dims, heads, ch, kernel, circular = case
    plan = dkv_bf16_plan(dims, kernel, circular, heads, ch, True)
    if one_row:
        plan = dataclasses.replace(plan, ry=1, whole=min(plan.jth, plan.tile.uh) == 1)
    got = kernel_parts(dims, kernel, circular, plan)
    want = tile_parts(dims, heads, ch, kernel, circular)
    assert got.keys() == want.keys()
    for key, parts in got.items():
        flat = [q for part in parts for q in part]
        assert len(flat) == len(set(flat)) == sum(map(len, want[key])), key
        assert [sorted(p) for p in parts] == [sorted(p) for p in want[key]], key


def test_dkv_bf16_plan_cases():
    """The plans the card tests take: the 1-degree layer's (2 x 8 x 4 keys,
    four warps, items of a TPU tile of H's rows, three CTAs an SM); key
    tiles that end inside a TPU tile; parts across the seam; one part where
    the TPU kernel has no tile; items of fewer rows than a tile of H where
    128 channels do not fit."""
    wm = dkv_bf16_plan((14, 45, 90), (3, 5, 5), False, 4, 32, True)
    assert (wm.tile.td, wm.tile.th, wm.tile.tw, wm.ry, wm.jth, wm.jtw, wm.whole, wm.warps, wm.ctas) == (
        2, 8, 4, 4, 4, 3, True, 4, 3)
    inside = dkv_bf16_plan((4, 15, 26), (3, 5, 5), False, 4, 32, True)
    assert inside.tile.th % inside.jth and inside.tile.tw % inside.jtw
    seam = dkv_bf16_plan((3, 8, 22), (3, 3, 7), True, 4, 32, True)
    assert 22 % seam.jtw and seam.jtw < 22
    assert tpu_backward_tile((8, 16, 24), (3, 7, 7), False, 8, 16, True) is None
    one = dkv_bf16_plan((8, 16, 24), (3, 7, 7), False, 8, 16, True)
    assert (one.jth, one.jtw) == (16, 24) and one.whole
    wide = dkv_bf16_plan((14, 45, 90), (3, 5, 5), False, 1, 128, True)
    assert not wide.whole and 1 <= wide.ry < wide.jth and wide.tile.smem <= natten_flash.SMEM_LIMIT
    for plan in (wm, inside, seam, one, wide):
        assert plan.tile.th % DKV16_PATCH[0] == 0 and plan.tile.tw % DKV16_PATCH[1] == 0
        assert plan.tile.smem <= natten_flash.SMEM_LIMIT and 1 <= plan.warps <= natten_flash.DKV16_MAX_WARPS
        assert plan.ctas == 1 or (plan.warps <= 4 and 3 * (plan.tile.smem + 1024) <= natten_flash.SM_SMEM)
    # a key tile of more than DKV16_MAX_WARPS patches, or of part patches, is no plan
    assert dkv16_tile_plan((4, 8, 16), (14, 45, 90), (3, 5, 5), False, (4, 3), 32) is None
    assert dkv16_tile_plan((1, 6, 8), (14, 45, 90), (3, 5, 5), False, (4, 3), 32) is None


def test_dkv_bf16_segments_and_items():
    """Pieces of columns cut at the TPU tiles of W in wrapped columns (the
    seam cuts a partial last tile from the first), none where one tile spans
    W; items cut at the TPU tiles of H, whole or of ry rows a tile of W."""
    assert dkv_bf16_segments(-3, 4, 22, 6) == [(-3, 0), (0, 4)]
    assert dkv_bf16_segments(3, 9, 11, 11) == [(3, 9)]
    assert dkv_bf16_segments(8, 15, 11, 6) == [(8, 11), (11, 15)]
    assert dkv_bf16_items(2, 12, 0, 8, 40, 4, 3, 4) == [
        (2, 4, 0, 8, True), (4, 8, 0, 8, True), (8, 12, 0, 8, True), (12, 14, 0, 8, True)]
    assert dkv_bf16_items(0, 14, -2, 9, 11, 14, 11, 14) == [(0, 14, -2, 9, True)]
    assert dkv_bf16_items(3, 5, 1, 7, 40, 4, 3, 2) == [
        (3, 4, 1, 3, True), (3, 4, 3, 6, True), (3, 4, 6, 7, True),
        (4, 6, 1, 3, False), (6, 8, 1, 3, True), (4, 6, 3, 6, False), (6, 8, 3, 6, True),
        (4, 6, 6, 7, False), (6, 8, 6, 7, True)]
