"""The tiles of the 3D neighborhood attention forward K5a
(csrc/natten_flash.cu), on the CPU.

A CTA owns td x th query rows (one warp each) of TW W-columns; a group of
lanes owns NQ W-neighbouring queries (the constant of the source, which the
walk reads, with the chunk widths NC_SHORT and NC_LONG and the CTA's
THREADS). The CTA walks the key planes of its tile's D windows: each slab
(the union of the tile's windows in one key plane) is staged in items of
ry rows by rx columns, in two stages, and for each key row of its query
row's window a group takes its queries' union of columns in chunks of NC,
masking each query's pair by its window. `fwd_walk` below enumerates the
pairs the kernel computes, from `_fwd_plan` or from smaller tiles and
strips, with the staged position each reads; the tests check that every
(query, key) pair of every window is computed exactly once, from the right
plane, stage and staged row, with the right slot and relative offset;
that the reduce-scatter of the partial logits leaves each query's sums on
the lanes that the broadcasts read; and hold out and lse computed along the
walk, in its order (an online softmax in log2 units, rescaled once a
chunk), against the JAX package's K5a in interpret mode. The last tests
check the plans against the shared memory and the CTA, on the shapes that
`takes` accepts. Tolerance: 2e-5, the JAX package's on the forward.
"""

import itertools
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.ops.pallas import natten_flash as jax_flash
from graph_weather_tpu_torch.ops import natten_flash
from graph_weather_tpu_torch.ops.natten_flash import FwdPlan, _fwd_plan, _max_span
from test_torch_natten_bwd_tiles import TILES_BEFORE, all_pairs, flat, start_w, window_start

torch.set_num_threads(1)
FWD_ATOL = 2e-5
LOG2E = 1.4426950408889634
SOURCE = Path(natten_flash.__file__).resolve().parents[1] / "csrc" / "natten_flash.cu"


def _constants():
    """The kernel's lane group, chunks and CTA, read from its source."""
    text = SOURCE.read_text()
    return {name: int(value) for name, value in re.findall(
        r"\b(NQ|NC_SHORT|NC_LONG|THREADS) = (\d+);", text)}


KERNEL_CONSTANTS = _constants()
NQ = KERNEL_CONSTANTS["NQ"]


def test_host_constants_are_the_kernels():
    """The host plans with the source's lane group, chunks and CTA size."""
    assert natten_flash.FWD_NQ == NQ
    assert natten_flash.FWD_NC == (KERNEL_CONSTANTS["NC_SHORT"], KERNEL_CONSTANTS["NC_LONG"])
    assert natten_flash.FWD_THREADS == KERNEL_CONSTANTS["THREADS"]


def plan_with(dims, kernel, circular, ch, td, th, ry=None, rx=None):
    """The host's plan for the lane group and chunks, with the tile's rows
    (td, th) and item strips (ry, rx; None: the whole slab) replaced."""
    p = _fwd_plan(dims, kernel, circular, ch, True)
    uh = _max_span(dims[1], kernel[1], th, False, False)
    uw = min(p.tw, dims[2]) + kernel[2] - 1 if circular else _max_span(dims[2], kernel[2], p.tw, False, False)
    n_tiles = math.prod(-(-s // t) for s, t in zip(dims, (td, th, p.tw)))
    return FwdPlan(p.cp, p.lanes, p.nc, td, th, p.tw, ry or uh, rx or uw, 0, 1, n_tiles)


def tile_union(dims, kernel, circular, plan, d0, h0, w0):
    """The tile's key planes, rows and unreduced columns, as the kernel
    computes them: [u0d, u1d), [u0h, u1h), [u0w, u1w)."""
    (D, H, W), (kd, kh, kw) = dims, kernel
    dl, hl, wl = min(d0 + plan.td, D) - 1, min(h0 + plan.th, H) - 1, min(w0 + plan.tw, W) - 1
    return (window_start(d0, D, kd), window_start(dl, D, kd) + kd,
            window_start(h0, H, kh), window_start(hl, H, kh) + kh,
            start_w(w0, W, kw, circular), start_w(wl, W, kw, circular) + kw)


def fwd_walk(dims, kernel, circular, plan):
    """The kernel's pairs, per query in the order it computes them: {query:
    [(step, key, slot, rel), ...]} with positions flat in the volume, a step
    (tile, item, key row, chunk) per online-softmax update. Checks on the
    way that each pair reads the key from the staged row that the item's
    copy put it in, within the stage's rows."""
    (D, H, W), (kd, kh, kw) = dims, kernel
    nrh, nrw = 2 * kh - 1, 2 * kw - 1
    n_chunks = -(-(NQ - 1 + kw) // plan.nc)
    walk = {}
    tiles = itertools.product(range(0, D, plan.td), range(0, H, plan.th), range(0, W, plan.tw))
    for t_id, (d0, h0, w0) in enumerate(tiles):
        u0d, u1d, u0h, u1h, u0w, u1w = tile_union(dims, kernel, circular, plan, d0, h0, w0)
        strips_h, strips_w = -(-(u1h - u0h) // plan.ry), -(-(u1w - u0w) // plan.rx)
        for it in range((u1d - u0d) * strips_h * strips_w):
            kp = u0d + it // (strips_h * strips_w)
            y0 = u0h + it // strips_w % strips_h * plan.ry
            c0 = u0w + it % strips_w * plan.rx
            y1, c1 = min(y0 + plan.ry, u1h), min(c0 + plan.rx, u1w)
            ncols = c1 - c0
            # The copy: staged row r holds position (kp, y0 + r // ncols, c0 + r % ncols).
            staged = [flat(dims, kp, y0 + r // ncols, (c0 + r % ncols) % W)
                      for r in range((y1 - y0) * ncols)]
            assert len(staged) <= plan.ry * plan.rx, "the item fits its stage"
            for warp in range(plan.td * plan.th):
                pd, ph = divmod(warp, plan.th)
                qd, qh = min(d0 + pd, D - 1), min(h0 + ph, H - 1)
                sd, sh = window_start(qd, D, kd), window_start(qh, H, kh)
                ya, yb = max(y0, sh), min(y1, sh + kh)
                if not (d0 + pd < D and h0 + ph < H and sd <= kp < sd + kd and ya < yb):
                    continue
                for qw0 in range(w0, w0 + plan.tw, NQ):
                    sw0 = start_w(min(qw0, W - 1), W, kw, circular)
                    for y, chunk in itertools.product(range(ya, yb), range(n_chunks)):
                        cs = sw0 + plan.nc * chunk
                        for j in range(NQ):
                            qw = min(qw0 + j, W - 1)
                            my_sw = start_w(qw, W, kw, circular)
                            if qw0 + j >= W:
                                continue  # computed, never stored
                            query = flat(dims, qd, qh, qw)
                            steps = walk.setdefault(query, [])
                            step = (t_id, it, y, chunk)
                            for cu in range(cs, cs + plan.nc):
                                if not (c0 <= cu < c1 and my_sw <= cu < my_sw + kw):
                                    continue
                                row = (y - y0) * ncols + min(max(cu - c0, 0), ncols - 1)
                                key = flat(dims, kp, y, cu % W)
                                assert staged[row] == key, "the staged row holds the key"
                                slot = ((kp - sd) * kh + y - sh) * kw + cu - my_sw
                                rel = ((kp - qd + kd - 1) * nrh + y - qh + kh - 1) * nrw + cu - qw + kw - 1
                                steps.append((step, key, slot, rel))
    return walk


def check_every_pair_once(dims, kernel, circular, plan):
    want = all_pairs(dims, kernel, circular)
    walk = fwd_walk(dims, kernel, circular, plan)
    got = [(query, key, slot, rel) for query, steps in walk.items() for _, key, slot, rel in steps]
    assert len(got) == len(want) and len({(a, b) for a, b, _, _ in got}) == len(want)
    assert all(want[(a, b)] == (s, r) for a, b, s, r in got)
    for steps in walk.values():  # each query's steps in the kernel's order
        assert [s for s, *_ in steps] == sorted(s for s, *_ in steps)


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("dims,kernel,ch,tiles", [
    # W shorter than tw + kw - 1; tiles cut by every edge of the volume
    ((5, 6, 11), (3, 3, 5), 32, [(2, 4, None, None), (4, 2, 2, 7)]),
    ((4, 7, 9), (3, 5, 5), 128, [(1, 8, None, None), (2, 4, 3, 4)]),  # four lanes a query
    ((5, 8, 9), (5, 7, 7), 16, [(8, 1, None, None), (2, 4, 4, 5)]),  # a group of four lanes
    ((5, 8, 18), (5, 7, 7), 32, [None]),  # the host's plan
])
def test_every_pair_once(dims, kernel, ch, tiles, circular):
    """The kernel computes every (query, key) pair of every window exactly
    once, with its window slot and relative offset, reading each key from
    the staged row the item's copy filled: whole slabs and strips of rows
    and columns, tiles of every split of the CTA's eight rows."""
    for tile in tiles:
        plan = _fwd_plan(dims, kernel, circular, ch, True) if tile is None else (
            plan_with(dims, kernel, circular, ch, *tile))
        check_every_pair_once(dims, kernel, circular, plan)


def reduce_scatter(partials, lanes, nq, nc):
    """The kernel's reduce-scatter over a group of `lanes` lanes, each with
    partial logits [nq, nc] in its slots, slot j holding query j ^ my_j
    (my_j: the lane's top bits): per lane bit from the top, each lane adds
    its partner's high slots to its low ones (then, where lanes remain, it
    keeps half of the columns; lower bits sum in full). Returns each lane's
    sums [ncl] and its (query, first column)."""
    ql = lanes // nq
    my_j = [(lane & (lanes - ql)) // ql for lane in range(lanes)]
    s = [np.array(partials[lane][[j ^ my_j[lane] for j in range(nq)]], dtype=np.float64)
         for lane in range(lanes)]
    half, bit = nq // 2, lanes // 2
    while half > 0:
        s = [s[lane][:half] + s[lane ^ bit][half:2 * half] for lane in range(lanes)]
        half, bit = half // 2, bit // 2
    x = [t[0] for t in s]
    if ql >= 2:
        h = ql // 2
        x = [np.where(lane & h, x[lane][nc // 2:] + x[lane ^ h][nc // 2:],
                      x[lane][:nc // 2] + x[lane ^ h][:nc // 2]) for lane in range(lanes)]
        bit = ql // 4
        while bit > 0:
            x = [x[lane] + x[lane ^ bit] for lane in range(lanes)]
            bit //= 2
    owner = [(my_j[lane], nc // 2 if ql >= 2 and lane & (ql // 2) else 0) for lane in range(lanes)]
    return x, owner


@pytest.mark.parametrize("lanes,nq", [(4, NQ), (8, NQ), (16, NQ), (8, 2), (8, 1), (4, 1)])
def test_reduce_scatter_leaves_each_query_on_its_holder(lanes, nq):
    """After the reduce-scatter each lane holds the group's full sums of its
    query's half of the chunk's columns, and the lane that a broadcast of
    slot j and column half h reads ((j * QL ^ qbits) + h * QL / 2 of the
    group) holds those of query j ^ my_j (the instantiations' groups of 4,
    8 and 16 lanes, and the variants' groups of one and two queries)."""
    nc = 10
    rng = np.random.default_rng(lanes * 10 + nq)
    partials = rng.standard_normal((lanes, nq, nc))
    x, owner = reduce_scatter(partials, lanes, nq, nc)
    full = partials.sum(0)
    ncl = len(x[0])
    for lane, (j, u0) in enumerate(owner):
        np.testing.assert_allclose(x[lane], full[j, u0:u0 + ncl], rtol=1e-12)
    ql = lanes // nq
    for lane, j, h in itertools.product(range(lanes), range(nq), range(nc // ncl)):
        qbits = lane & (lanes - ql)
        src = (j * ql ^ qbits) + h * (ql // 2)
        assert owner[src] == (j ^ owner[lane][0], h * ncl)


def emulate(q, k, v, rpb, kernel, circular, plan):
    """out and lse computed along the walk, in its order: logits in log2
    units (log2(e) in the scale and in rpb), per step the chunk's max, one
    rescale of the sum and of the accumulator, p = exp2(x - m), f32."""
    _, D, H, W, heads, ch = q.shape
    walk = fwd_walk((D, H, W), kernel, circular, plan)
    qf, kf, vf = (t.reshape(-1, heads, ch) for t in (q, k, v))
    rpbf = rpb.reshape(heads, -1) * LOG2E
    scale = ch**-0.5 * LOG2E
    n_q = qf.shape[0]
    # [query, step, column] keys, relative offsets and validity
    steps = {query: [] for query in range(n_q)}
    for query, pairs in walk.items():
        for step, group in itertools.groupby(pairs, key=lambda t: t[0]):
            steps[query].append([(key, rel) for _, key, _, rel in group])
    n_steps = max(len(s) for s in steps.values())
    width = max(len(c) for s in steps.values() for c in s)
    keys = torch.zeros(n_q, n_steps, width, dtype=torch.long)
    rels = torch.zeros(n_q, n_steps, width, dtype=torch.long)
    valid = torch.zeros(n_q, n_steps, width, dtype=torch.bool)
    for query, s in steps.items():
        for i, chunk in enumerate(s):
            for u, (key, rel) in enumerate(chunk):
                keys[query, i, u], rels[query, i, u], valid[query, i, u] = key, rel, True
    qs = qf * scale
    m = torch.full((n_q, heads), -1e30)
    lsum = torch.zeros(n_q, heads)
    acc = torch.zeros(n_q, heads, ch)
    for i in range(n_steps):
        x = (qs[:, None] * kf[keys[:, i]]).sum(-1) + rpbf[:, rels[:, i]].permute(1, 2, 0)  # [n, u, heads]
        ok = valid[:, i, :, None]
        cmax = torch.where(ok, x, torch.tensor(-1e30)).amax(1)
        m_new = torch.maximum(m, cmax)
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(x - m_new[:, None]), torch.tensor(0.0))
        lsum = lsum * alpha + p.sum(1)
        acc = acc * alpha[..., None] + (p[..., None] * vf[keys[:, i]]).sum(1)
        m = m_new
    out = (acc / lsum[..., None]).reshape(q.shape)
    lse = ((m + torch.log2(lsum)) / LOG2E).reshape(q.shape[:-1])
    return out, lse


@pytest.mark.parametrize("shape,kernel,circular,tile", [
    ((1, 3, 6, 8), (3, 3, 5), True, (2, 4, 3, 7)),
    ((1, 5, 9, 10), (5, 7, 7), False, None),
    ((1, 3, 6, 8), (3, 5, 5), False, (4, 2, None, None)),
])
def test_walk_matches_jax_k5a(shape, kernel, circular, tile):
    """out and lse along the emulated walk against the JAX package's K5a
    (_flash_fwd_impl with lse, interpret mode) at 4 heads of 32 (the JAX
    kernel's heads * ch must fill 128 lanes), numpy inputs from a seed."""
    heads, ch = 4, 32
    rng = np.random.default_rng(sum(kernel) + circular)
    q, k, v = (rng.standard_normal((*shape, heads, ch)).astype(np.float32) for _ in range(3))
    rpb = (0.5 * rng.standard_normal((heads, *(2 * kk - 1 for kk in kernel)))).astype(np.float32)
    th, tw = next((th, tw) for th, tw in jax_flash._candidate_tiles(*shape[1:4], kernel, circular)
                  if th <= shape[2] and tw <= shape[3])
    want, want_lse = jax_flash._flash_fwd_impl(
        *map(jnp.asarray, (q, k, v, rpb)), kernel, circular, th, tw, interpret=True, with_lse=True)
    dims = shape[1:4]
    plan = _fwd_plan(dims, kernel, circular, ch, True) if tile is None else (
        plan_with(dims, kernel, circular, ch, *tile))
    out, lse = emulate(*map(torch.from_numpy, (q, k, v, rpb)), kernel, circular, plan)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=FWD_ATOL)


@pytest.mark.parametrize("case", TILES_BEFORE, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-ch{c[3]}")
def test_plan_fits_for_every_shape_taken(case):
    """`_fwd_plan` answers every shape that `takes` accepts, within Hopper's
    shared memory (rpb and two stages of the item's K and V rows) and the
    SM's share of it for its CTAs, with a CTA of THREADS threads, a group
    of four queries on its lanes, and items inside the slab."""
    dims, kernel, circular, ch, has_bias, takes, _ = case
    if not takes:
        with pytest.raises(ValueError):
            natten_flash.takes((1, *dims, 4, ch), kernel, circular, has_bias)
        return
    plan = _fwd_plan(dims, kernel, circular, ch, has_bias)
    cp = natten_flash._padded_width(ch)
    n_rel = math.prod(2 * kk - 1 for kk in kernel)
    smem = (4 * -(-n_rel // 4) * 4 if has_bias else 0) + 2 * 2 * 4 * (cp + 4) * plan.ry * plan.rx
    assert plan.smem == smem <= natten_flash.SMEM_LIMIT
    assert plan.ctas * (smem + 1024) <= natten_flash.SM_SMEM
    assert plan.td * plan.th * 32 == natten_flash.FWD_THREADS <= 1024
    assert plan.cp == cp and plan.lanes == cp // natten_flash.FWD_GROUPS[cp][0] >= NQ
    assert plan.tw == NQ * 32 // plan.lanes and plan.nc in natten_flash.FWD_NC
    assert plan.nc % 2 == 0 or plan.lanes == NQ  # the column halving needs even chunks
    assert plan.ry <= _max_span(dims[1], kernel[1], plan.th, False, False)
    assert plan.rx <= min(plan.tw, dims[2]) + kernel[2] - 1


def test_plan_of_the_model_layers():
    """The plans of the 128-d WeatherMesh's layers (phase 18's case a) and
    of (5, 7, 7) at 8 x 32 (case c): whole slabs, two CTAs an SM (16
    warps)."""
    a = _fwd_plan((14, 45, 90), (3, 5, 5), False, 32, True)
    c = _fwd_plan((14, 45, 90), (5, 7, 7), False, 32, True)
    assert (a.td, a.th, a.tw, a.ry, a.rx, a.ctas) == (2, 4, 16, 8, 20, 2)
    assert (c.td, c.th, c.tw, c.ry, c.rx, c.ctas) == (4, 2, 16, 8, 22, 2)
    assert a.nc == 8 and c.nc == 10
