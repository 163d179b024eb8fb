"""The tiles of K6b, the backward of the wide-head 3D neighborhood attention
K6 (csrc/natten3d_bwd.cu), on the CPU.

Both kernels run on K6's tiles (ops/natten3d.plan_backward). The dq kernel
gives a CTA `rows` query rows by 4 * 32 / lanes columns of one D plane and
stages, per key plane (slab) of the tile's D window, the union of its
queries' windows in items of ry rows by rx columns; a group of lanes owns
four W-neighbouring queries and takes, per key row of their window, the
four windows' union of columns in chunks of NC, masking each query's pair by
its window. With rpb it keeps ds per (tile query, slot of the slab) and,
after the slab's last item, sums it per (rh, rw) offset from per-axis slot
tables into the CTA's drpb partials. It also stores each in-window pair's
p and ds at the query's window slot of the slot table (`natten3d.table_shape`,
query-major: [B, D, H, W, heads, kd * kh * kw, (p, ds)]). The dk/dv kernel
gives a CTA `rows` key rows by NK * 32 / lanes columns of one D plane, walks
the query planes of its plane's inverse window and stages, per plane, the
union of its keys' inverse windows (q and dO rows) in items; a group owns NK
W-neighbouring keys and takes, per query row of its key row's range, every
query column of its keys' union within the item, reading for each key whose
slot the query's window has that slot's p and ds from the table.
`dq_walk` and `dkv_walk` enumerate the pairs each kernel computes, item by
item, row by row and chunk (dq) or column (dk/dv) by column, from the
host's plans or from plans whose strips are forced down to one row, with the
staged position each reads and the table slot each writes (dq) or reads
(dk/dv). The tests check that every (query, key) pair of every window is
computed exactly once in each kernel, from the staged row of its key (dq)
or query (dk/dv), with the right slot and relative offset; that the dq
kernel writes every slot of every query exactly once and the dk/dv kernel
reads each pair's p and ds from the slot the dq kernel wrote it to; and
hold the gradients computed along the walks (dk and dv from the table the
dq walk filled, drpb through the kernel's per-slab tables) against jax.vjp
of the JAX package's K6 run in interpret mode, whose backward differentiates
the XLA slot scan. Tolerance: 2e-5, the JAX package's on K6 (f32 sums over
at most 245 keys in another order).
"""

import dataclasses
import functools
import itertools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.ops.pallas.natten3d import neighborhood_attention_3d_pallas
from graph_weather_tpu_torch.ops import natten3d
from graph_weather_tpu_torch.ops.natten_flash import SMEM_LIMIT, _NattenFlash
from graph_weather_tpu_torch.ops.neighborhood_attention import neighborhood_attention_3d_reference
from test_torch_natten3d_tiles import _inputs, start_w, tile_union, window_start
from test_torch_natten_bwd_tiles import all_pairs, flat, inverse_hi, inverse_lo

torch.set_num_threads(1)
ATOL = 2e-5
SOURCE = Path(natten3d.__file__).resolve().parents[1] / "csrc" / "natten3d_bwd.cu"


def _constants():
    """The kernels' lane groups and chunks, read from their source."""
    text = SOURCE.read_text()
    found = {name: int(value) for name, value in re.findall(r"\b(NQ|NC|NK) = (\d+);", text)}
    cases = {int(cp): int(lanes) for cp, lanes in re.findall(r"case (\d+) \* 64 \+ (\d+):", text)}
    return found, cases


CONSTANTS, INSTANTIATIONS = _constants()
NQ, NC, NK = (CONSTANTS[n] for n in ("NQ", "NC", "NK"))


def test_host_constants_are_the_kernels():
    """The host's groups and lanes (ops/natten3d.py) are the source's: four
    queries a dq group, NK keys a dk/dv group, and an instantiation for
    every padded head width at the lanes `_bwd_lanes` picks."""
    assert (natten3d.BWD_NQ, natten3d.BWD_NK) == (NQ, NK) and NQ == 4
    assert INSTANTIATIONS == {cp: natten3d._bwd_lanes(cp) for cp in natten3d.TILE_WIDTHS}
    # table_at: the row-major index of natten3d.table_shape's [B, D, H, W,
    # heads, kd, slots of a plane], the plane's slots padded to even
    text = SOURCE.read_text()
    assert ("((((long long)b * g.d * g.h * g.w + pos) * g.heads + head) * g.kd + x) * "
            "slab_slots(g) + s;") in text
    assert "return (g.kh * g.kw + 1) & ~1;" in text
    assert re.search(r"\bDKV_CTAS = (\d+);", text).group(1) == str(natten3d.BWD_DKV_CTAS)


def _items(u0h, u1h, u0w, u1w, planes, ry, rx):
    """A CTA's items in the kernel's order: plane, strip of rows, strip of
    columns."""
    return [(x, y0, min(y0 + ry, u1h), c0, min(c0 + rx, u1w)) for x in range(planes)
            for y0 in range(u0h, u1h, ry) for c0 in range(u0w, u1w, rx)]


def _start_w(i, w, kw, circular):
    """start_w over an array of positions."""
    return i - kw // 2 if circular else np.clip(i - kw // 2, 0, w - kw)


def dq_walk(shape, kernel, circular, plan):
    """The dq kernel's pairs of live queries, one row each: (query, key,
    slot, rel, cta, local query), positions flat in the volume, slot and rel
    flat, local = tile row * columns + tile column. A group walks its key
    rows item by item and chunk by chunk (columns cu, a grid per item
    here)."""
    _, D, H, W = shape[:4]
    kd, kh, kw = kernel
    nrh, nrw = 2 * kh - 1, 2 * kw - 1
    rows, tw = plan.rows, plan.columns
    cols = np.arange(-(-(NQ - 1 + kw) // NC) * NC)  # the chunks' columns
    out = []
    ctas = itertools.product(range(D), range(0, H, rows), range(0, W, tw))
    for cta, (qd, h0, w0) in enumerate(ctas):
        sd = window_start(qd, D, kd)
        u0h, u1h, u0w, u1w = tile_union(h0, w0, rows, tw, shape, kernel, circular)
        items = _items(u0h, u1h, u0w, u1w, kd, plan.ry, plan.rx)
        for warp, g in itertools.product(range(rows), range(tw // NQ)):
            qh, qw0 = min(h0 + warp, H - 1), w0 + NQ * g
            if h0 + warp >= H or qw0 >= W:  # no live query: nothing stored
                continue
            qw = np.minimum(qw0 + np.arange(NQ), W - 1)
            live = qw0 + np.arange(NQ) < W
            sw = _start_w(qw, W, kw, circular)
            sh, sw0 = window_start(qh, H, kh), start_w(int(qw[0]), W, kw, circular)
            for x, y0, y1, c0, c1 in items:
                assert (y1 - y0) * (c1 - c0) <= plan.ry * plan.rx
                if y1 <= sh or y0 >= sh + kh or c1 <= sw[0] or c0 >= sw[-1] + kw:
                    continue  # no pair of the group in the item
                y, cu, j = np.meshgrid(np.arange(max(y0, sh), min(y1, sh + kh)), sw0 + cols,
                                       np.arange(NQ), indexing="ij")
                r = (y - y0) * (c1 - c0) + np.clip(cu - c0, 0, c1 - c0 - 1)  # the staged row read
                ok = live[j] & (cu >= c0) & (cu < c1) & (cu >= sw[j]) & (cu < sw[j] + kw)
                y, cu, j, r = y[ok], cu[ok], j[ok], r[ok]
                assert (y0 + r // (c1 - c0) == y).all(), "the staged row is the key's"
                assert ((c0 + r % (c1 - c0)) % W == cu % W).all(), "the staged column is the key's"
                rel = ((sd + x - qd + kd - 1) * nrh + y - qh + kh - 1) * nrw + cu - qw[j] + kw - 1
                out.append(np.stack([
                    flat((D, H, W), qd, qh, qw[j]), flat((D, H, W), sd + x, y, cu % W),
                    (x * kh + y - sh) * kw + cu - sw[j], rel, np.full_like(j, cta),
                    warp * tw + qw0 - w0 + j], axis=1))
    return np.concatenate(out)


def dkv_walk(shape, kernel, circular, plan):
    """The dk/dv kernel's pairs of live keys, one row each: (query, key,
    slot, rel), the slot of the table it reads, as the kernel computes it
    (the key plane's and key row's slot in the query's windows, plus the
    key column less the query's window start). A group walks the query rows
    of its key row's range item by item and, in each, every query column of
    its keys' union of inverse windows within the item."""
    _, D, H, W = shape[:4]
    kd, kh, kw = kernel
    nrh, nrw = 2 * kh - 1, 2 * kw - 1
    rows, tw = plan.rows, plan.columns
    out = []
    for jd, h0, w0 in itertools.product(range(D), range(0, H, rows), range(0, W, tw)):
        pd0 = inverse_lo(jd, D, kd, False)
        planes = inverse_hi(jd, D, kd, False) - pd0 + 1
        hl, wl = min(h0 + rows, H) - 1, min(w0 + tw, W) - 1
        u0h, u1h = inverse_lo(h0, H, kh, False), inverse_hi(hl, H, kh, False) + 1
        u0w, u1w = inverse_lo(w0, W, kw, circular), inverse_hi(wl, W, kw, circular) + 1
        items = _items(u0h, u1h, u0w, u1w, planes, plan.ry, plan.rx)
        for warp, g in itertools.product(range(rows), range(tw // NK)):
            if h0 + warp >= H:
                continue
            jh = h0 + warp
            live = w0 + NK * g + np.arange(NK) < W
            kw_ = np.minimum(w0 + NK * g + np.arange(NK), W - 1)
            qh_lo, qh_hi = inverse_lo(jh, H, kh, False), inverse_hi(jh, H, kh, False)
            qc_lo, qc_hi = inverse_lo(int(kw_[0]), W, kw, circular), inverse_hi(int(kw_[-1]), W, kw, circular)
            for x, y0, y1, c0, c1 in items:
                assert (y1 - y0) * (c1 - c0) <= plan.ry * plan.rx
                pd = pd0 + x
                ya, yb, ca, cb = max(y0, qh_lo), min(y1, qh_hi + 1), max(c0, qc_lo), min(c1, qc_hi + 1)
                if ya >= yb or ca >= cb:
                    continue  # no pair of the group in the item
                y, cu, j = np.meshgrid(np.arange(ya, yb), np.arange(ca, cb), np.arange(NK), indexing="ij")
                r = (y - y0) * (c1 - c0) + cu - c0  # the staged row read
                z = kw_[j] - _start_w(cu, W, kw, circular)
                ok = live[j] & (z >= 0) & (z < kw)
                y, cu, j, r, z = y[ok], cu[ok], j[ok], r[ok], z[ok]
                assert (y0 + r // (c1 - c0) == y).all(), "the staged row is the query's"
                assert ((c0 + r % (c1 - c0)) % W == cu % W).all(), "the staged column is the query's"
                slot = ((jd - window_start(pd, D, kd)) * kh + jh - np.clip(y - kh // 2, 0, H - kh)) * kw + z
                rel = ((jd - pd + kd - 1) * nrh + jh - y + kh - 1) * nrw + kw_[j] - cu + kw - 1
                out.append(np.stack([flat((D, H, W), pd, y, cu % W), flat((D, H, W), jd, jh, kw_[j]),
                                     slot, rel], axis=1))
    return np.concatenate(out)


def slot_table(size, k, t, i0, circular):
    """[2k - 1, t] slot of each tile query at each relative offset, -1 for
    none or a query past the axis (the dq kernel's t_h and t_w)."""
    table = np.full((2 * k - 1, t), -1)
    for r, qi in itertools.product(range(2 * k - 1), range(t)):
        if i0 + qi < size:
            s = (r - (k - 1) + k // 2 if circular
                 else i0 + qi + r - (k - 1) - window_start(i0 + qi, size, k))
            table[r, qi] = s if 0 <= s < k else -1
    return table


def emulate(q, k, v, rpb, dout, kernel, circular, plans, walks):
    """dq, dk, dv, drpb computed along the two kernels' walks (on `plans`),
    f32: dk and dv from the slot table the dq walk filled (unwritten slots
    NaN); drpb through the dq kernel's per-slab tables and per-CTA
    partials."""
    b_sz, D, H, W, heads, ch = q.shape
    kd, kh, kw = kernel
    scale = ch**-0.5
    out, lse = neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular, with_lse=True)
    delta = (dout * out).sum(-1).reshape(b_sz, -1, heads)
    qf, kf, vf, df = (t.reshape(b_sz, -1, heads, ch) for t in (q, k, v, dout))
    lsef = lse.reshape(b_sz, -1, heads)
    rpbf = rpb.reshape(heads, -1) if rpb is not None else None
    # q.k and dO.v of every (query, key) pair of the volume, [B, n, n, heads]:
    # the walks pick theirs
    s_all = torch.einsum("bqhc,bkhc->bqkh", qf, kf) * scale
    dp_all = torch.einsum("bqhc,bkhc->bqkh", df, vf)

    def pair_terms(qi, ki, rel):  # p and ds [B, pairs, heads]
        s = s_all[:, qi, ki]
        if rpbf is not None:
            s = s + rpbf[:, rel].T
        p = torch.exp(s - lsef[:, qi])
        return p, p * (dp_all[:, qi, ki] - delta[:, qi])

    def dense(qi, ki, x):  # x [B, pairs, heads] at its pairs, [n, n, B, heads], summed where a pair repeats
        n = qf.shape[1]
        return torch.zeros(n, n, b_sz, heads).index_put_((qi, ki), x.transpose(0, 1), accumulate=True)

    walk = torch.from_numpy(walks[natten3d.DQ])
    qi, ki, slot, rel, cta, local = walk.T
    p, ds = pair_terms(qi, ki, rel)
    dq = torch.einsum("qkbh,bkhc->bqhc", dense(qi, ki, ds), kf) * scale
    # the slot table as the dq kernel stores it, [query, slot, B, heads, (p, ds)]
    slots = torch.full((qf.shape[1], math.prod(kernel), b_sz, heads, 2), float("nan"))
    slots[qi, slot] = torch.stack([p, ds], -1).transpose(0, 1)
    drpb = None
    if rpb is not None:
        plan = plans[natten3d.DQ]
        nrh, nrw = 2 * kh - 1, 2 * kw - 1
        partial = torch.zeros(b_sz, int(cta.max()) + 1, heads, 2 * kd - 1, nrh, nrw)
        ctas = itertools.product(range(D), range(0, H, plan.rows), range(0, W, plan.columns))
        for c, (qd, h0, w0) in enumerate(ctas):
            sel = cta == c
            # the per-slab tables of ds by (tile query, slot), all slabs at once
            table = torch.zeros(b_sz, plan.rows * plan.columns, kd, kh * kw, heads)
            table[:, local[sel], slot[sel] // (kh * kw), slot[sel] % (kh * kw)] = ds[:, sel]
            t_h = slot_table(H, kh, plan.rows, h0, False)[:, None, :, None]  # [rh, 1, row, 1]
            t_w = slot_table(W, kw, plan.columns, w0, circular)[None, :, None, :]  # [1, rw, 1, col]
            valid = torch.from_numpy((t_h >= 0) & (t_w >= 0))
            at = torch.from_numpy(np.broadcast_to(np.maximum(t_h, 0) * kw + np.maximum(t_w, 0),
                                                  valid.shape).copy())
            q_loc = torch.arange(plan.rows * plan.columns).reshape(1, 1, plan.rows, plan.columns)
            rd0 = window_start(qd, D, kd) - qd + kd - 1
            for x in range(kd):  # a slab's sums per (rh, rw) over the tile's queries
                terms = table[:, q_loc.expand_as(at), x, at] * valid[None, ..., None]
                partial[:, c, :, rd0 + x] = terms.sum((3, 4)).permute(0, 3, 1, 2)
        drpb = partial.sum((0, 1)).reshape(rpb.shape)
    walk = torch.from_numpy(walks[natten3d.DKV])
    qi, ki, slot, _ = walk.T
    p, ds = slots[qi, slot].transpose(0, 1).unbind(-1)  # [B, pairs, heads] each
    dk = torch.einsum("qkbh,bqhc->bkhc", dense(qi, ki, ds), qf) * scale
    dv = torch.einsum("qkbh,bqhc->bkhc", dense(qi, ki, p), df)
    return [t.reshape(q.shape) for t in (dq, dk, dv)] + [drpb]


def one_row_strips(plans):
    """The plans with every item cut down to one row (the heads of 256
    channels' plans also cut the columns into strips)."""
    return tuple(dataclasses.replace(p, ry=1) for p in plans)


@functools.cache
def _walks(case, strips):
    """A case's plans (cut to one-row strips where asked) and both kernels'
    walks on them, (dq, dk/dv), computed once for the tests that take them."""
    shape, heads, ch, kernel, with_rpb, circular = case
    full = (*shape, heads, ch)
    plans = natten3d.plan_backward(full, kernel, circular, with_rpb)
    if strips == "one_row":
        plans = one_row_strips(plans)
    return plans, (dq_walk(full, kernel, circular, plans[natten3d.DQ]),
                   dkv_walk(full, kernel, circular, plans[natten3d.DKV]))


# (B, D, H, W), heads, ch, kernel, rpb, circular_w; heads * ch a multiple of
# 128, as the JAX K6 needs
CASES = [
    ((1, 5, 7, 8), 4, 96, (5, 7, 7), True, False),  # the 768-d layer's heads, clamped
    ((1, 5, 7, 8), 4, 96, (5, 7, 7), True, True),  # across the circular seam
    ((1, 5, 8, 7), 1, 256, (5, 7, 7), True, False),  # 32 lanes a group, H past 8 rows
    ((2, 4, 6, 10), 2, 64, (3, 5, 5), True, True),
    ((1, 4, 9, 11), 2, 64, (3, 5, 5), False, False),  # no rpb, groups past W
]
IDS = ["k577_96", "k577_96_circular", "k577_256", "k335_64_circular_b2", "k335_64_no_rpb"]


@pytest.mark.parametrize("strips", ["plan", "one_row"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_every_pair_once_in_each_kernel(case, strips):
    """Each kernel computes every (query, key) pair of every window exactly
    once, with its slot and relative offset, on the host's plans and on
    items of one row."""
    shape, _, _, kernel, _, circular = case
    want = np.array(sorted((*qk, *sr) for qk, sr in all_pairs(shape[1:], kernel, circular).items()))
    for walk in _walks(case, strips)[1]:
        assert len(np.unique(walk[:, :2], axis=0)) == len(walk), "a pair computed twice"
        np.testing.assert_array_equal(walk[np.lexsort((walk[:, 1], walk[:, 0])), :4], want)


@pytest.mark.parametrize("strips", ["plan", "one_row"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_table_written_once_and_read_where_written(case, strips):
    """The dq kernel stores every slot of every query of the table exactly
    once (in the layout `natten3d.table_shape` names, at one (batch, head):
    the grid's others take the same walk), and the dk/dv kernel reads each
    pair's p and ds once, from the slot the dq kernel stored that pair at."""
    shape, heads, ch, kernel, _, _ = case
    n, (kd, kh, kw) = math.prod(shape[1:]), kernel
    sp = kh * kw + kh * kw % 2  # a key plane's slots, padded to 16 bytes
    assert natten3d.table_shape((*shape, heads, ch), kernel) == (*shape, heads, kd, sp, 2)
    dq, dkv = _walks(case, strips)[1]

    def entry(walk):  # flat entry of (query, head 0, key plane, slot in the plane)
        return (walk[:, 0] * heads * kd + walk[:, 2] // (kh * kw)) * sp + walk[:, 2] % (kh * kw)

    stored, read = entry(dq), entry(dkv)
    assert len(np.unique(stored)) == len(stored) == n * kd * kh * kw, "a slot stored twice or never"
    assert set(stored // (kd * sp) // heads) == set(range(n))
    assert len(np.unique(read)) == len(read) == len(stored), "a slot read twice or never"
    by_pair = [w[np.lexsort((w[:, 1], w[:, 0]))] for w in (dq, dkv)]
    np.testing.assert_array_equal(by_pair[0][:, :3], by_pair[1][:, :3])


def _jax_grads(q, k, v, rpb, dout, kernel, circular):
    """jax.vjp of the JAX package's K6 (interpret mode, under jit), whose
    backward differentiates the XLA slot scan."""
    args = [jnp.asarray(a) for a in (q, k, v) + ((rpb,) if rpb is not None else ())]

    def f(*a):
        return neighborhood_attention_3d_pallas(*a[:3], kernel, a[3] if len(a) > 3 else None,
                                                circular, interpret=True)

    grads = jax.jit(lambda d, *a: jax.vjp(f, *a)[1](d))(jnp.asarray(dout), *args)
    return [np.asarray(g) for g in grads]


@functools.cache
def _case(case):
    """A case's inputs (q, k, v, rpb, dO as numpy) and its JAX gradients,
    computed once for all the tests that take the case."""
    shape, heads, ch, kernel, with_rpb, circular = case
    q, k, v, rpb = _inputs(shape, heads, ch, kernel, with_rpb, seed=ch)
    dout = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)
    return (q, k, v, rpb, dout), _jax_grads(q, k, v, rpb, dout, kernel, circular)


@pytest.mark.parametrize("case,strips", [(c, "plan") for c in CASES] + [(CASES[0], "one_row")],
                         ids=IDS + [IDS[0] + "_one_row"])
def test_walks_match_jax_k6(case, strips):
    """dq, dk, dv and drpb along the walks (on the host's plans, and on
    one-row strips at the 768-d heads) against jax.vjp of the JAX K6; and
    the gradients of `_NattenFlash` with natten3d's KERNELS (K6 and K6b's
    autograd Function) on CPU tensors."""
    shape, heads, ch, kernel, with_rpb, circular = case
    inputs, want = _case(case)
    t = [None if a is None else torch.from_numpy(a) for a in inputs]
    got = emulate(*t, kernel, circular, *_walks(case, strips))
    assert (got[3] is None) == (not with_rpb) and len(want) == 3 + with_rpb
    for name, a, b in zip(("dq", "dk", "dv", "drpb"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, err_msg=name)
    # The autograd Function of the card's path, on CPU tensors its plain
    # versions (the forward with lse, natten_flash_backward_reference).
    leaves = [x.clone().requires_grad_(True) for x in t[:4] if x is not None]
    out = _NattenFlash.apply(*leaves[:3], leaves[3] if with_rpb else None, kernel, circular,
                             natten3d.KERNELS)
    for name, a, b in zip(("dq", "dk", "dv", "drpb"), torch.autograd.grad(out, leaves, t[4]), want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, err_msg=f"_NattenFlash {name}")


# Every shape of the card's K6 tests (tests/test_torch_kernels_cuda.py) and
# chip_smoke.py's phase 41, with and without rpb, clamped and circular.
PLAN_SHAPES = [
    ((1, 14, 45, 90, 8, 96), (5, 7, 7)),
    ((1, 14, 45, 90, 4, 32), (3, 5, 5)),
    ((1, 14, 45, 90, 2, 256), (3, 5, 5)),
    ((1, 14, 45, 90, 2, 128), (5, 7, 7)),
    ((1, 14, 45, 90, 4, 64), (3, 5, 5)),
    ((2, 4, 7, 9, 3, 5), (3, 3, 3)),
    ((2, 5, 6, 7, 2, 200), (5, 5, 7)),
    ((1, 3, 5, 12, 1, 1), (3, 5, 12)),
    ((1, 6, 13, 21, 2, 96), (5, 7, 7)),
    ((2, 7, 11, 19, 3, 64), (5, 7, 7)),
    ((1, 5, 9, 18, 2, 128), (5, 7, 7)),
]


@pytest.mark.parametrize("shape,kernel", PLAN_SHAPES, ids=lambda c: str(c))
def test_plans_fit_shared_memory(shape, kernel):
    """Both plans of every shape fit Hopper's 227 KB; their items hold the
    largest union any tile stages, in strips; both count the slot table's
    bytes (device memory); the 768-d layer's dq kernel takes K6's tile (8
    rows x 16 columns, strips of 5 x 22)."""
    for circular, bias in itertools.product((False, True), (False, True)):
        dq, dkv = natten3d.plan_backward(shape, kernel, circular, bias)
        for p in (dq, dkv):
            assert p.smem <= SMEM_LIMIT and p.ry >= 1 and p.rx >= 1 and 1 <= p.rows <= 8
            assert p.cp >= shape[-1] and p.lanes == natten3d._bwd_lanes(p.cp)
        assert dq.columns == NQ * 32 // dq.lanes and dkv.columns == NK * 32 // dkv.lanes
        assert dq.table == dkv.table == 4 * math.prod(natten3d.table_shape(shape, kernel))
        _, d, h, w, _, _ = shape
        assert dq.n_tiles == d * -(-h // dq.rows) * -(-w // dq.columns)
    if shape[-1] == 96:
        fwd = natten3d.plan(shape, kernel, False)
        dq = natten3d.plan_backward(shape, kernel, False, True)[natten3d.DQ]
        assert (dq.rows, dq.columns, dq.ry, dq.rx) == (fwd.rows, fwd.columns, fwd.ry, fwd.rx)


def test_takes_refuses_what_no_backward_tile_fits():
    """A kernel whose dq table of ds per slot leaves no room for one staged
    position at one query row: K6 serves it, K6b refuses it before any
    launch; without rpb (no table) both take it."""
    shape, kernel = (1, 1, 61, 61, 1, 8), (1, 61, 61)
    assert natten3d.takes(shape, kernel, False, True)
    with pytest.raises(ValueError, match="no backward tile"):
        natten3d.takes(shape, kernel, False, True, backward=True)
    assert natten3d.takes(shape, kernel, False, False, backward=True)
    assert math.prod(2 * kk - 1 for kk in kernel) * 4 <= SMEM_LIMIT


def test_dkv_plan_takes_one_cta_an_sm_for_wide_windows():
    """The dk/dv kernel stages each query's slots of a key plane: a window
    whose slots do not fit BWD_DKV_CTAS CTAs an SM takes items of one
    position within 227 KB (one CTA an SM); one whose slots of a single
    query do not fit 227 KB is refused before any launch."""
    wide, wider = (1, 87, 87), (1, 121, 121)
    dkv = natten3d.plan_backward((1, 1, 87, 87, 1, 8), wide, False, False)[natten3d.DKV]
    assert (dkv.ry, dkv.rx) == (1, 1)
    assert natten3d.SM_SMEM // natten3d.BWD_DKV_CTAS < dkv.smem <= SMEM_LIMIT
    assert natten3d.takes((1, 1, 87, 87, 1, 8), wide, False, False, backward=True)
    assert natten3d.takes((1, 1, 121, 121, 1, 8), wider, False, False)
    with pytest.raises(ValueError, match="staged slots of one query"):
        natten3d.takes((1, 1, 121, 121, 1, 8), wider, False, False, backward=True)
