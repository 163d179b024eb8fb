"""The tiles of the 3D neighborhood attention backward K5b
(csrc/natten_flash_bwd.cu), on the CPU.

Both kernels give a group of lanes W-neighbouring positions of a tile (four
queries in the dq kernel, two keys in the dk/dv kernel: the constants NQ_DQ
and NQ_DKV of the source, which the walks read). The dq kernel stages its
query tile's K/V halo, a copy group per D plane (a warp's key plane x waits
for the halo's first x + td planes), and walks, for each key row of the
group's windows, their union of columns (NQ_DQ - 1 + kw, the same for every
group), masking each query's pair by its window; it keeps ds per (query,
slot) and sums drpb per relative offset from per-axis tables of each
query's slot. The dk/dv kernel stages its key tile's inverse window (the
queries whose window holds one of its keys) one D plane at a time, in strips
of `_dkv_rows` rows, and walks for each query row of a key's range the
group's keys' union of query columns, masking each key's pair by the
query's window. `dq_walk` and `dkv_walk` below enumerate the pairs each
kernel computes, from the host's tiles (`_pick_tile`, `_dkv_rows`) or
smaller ones, with the staged position each reads; the tests check that
every (query, key) pair of every window is computed exactly once in each
kernel, from the right staged row, with the right slot and relative offset,
and hold the gradients computed along these walks against jax.grad through
the JAX package's K5b in interpret mode (as tests/test_torch_natten.py
does), at kernels (3, 3, 5) and (5, 7, 7), clamped and circular. The last
test pins that `takes` and `_pick_tile` answer as before on the shapes the
card's runs and tests use. Tolerance: 5e-5, the JAX package's on gradients.
"""

import itertools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.ops.pallas import natten_flash as jax_flash
from graph_weather_tpu_torch.ops import natten_flash
from graph_weather_tpu_torch.ops.natten_flash import Tile, _dkv_rows, _max_span, _pick_tile
from graph_weather_tpu_torch.ops.neighborhood_attention import neighborhood_attention_3d_reference

torch.set_num_threads(1)
GRAD_ATOL = 5e-5
SOURCE = Path(natten_flash.__file__).resolve().parents[1] / "csrc" / "natten_flash_bwd.cu"


def _constants():
    """The kernels' lane groups, read from their source: W positions of a
    group in the dq and dk/dv kernels, and channels of a lane."""
    text = SOURCE.read_text()
    return {name: int(value) for name, value in re.findall(
        r"\b(NQ_DQ|CH_DQ|NQ_DKV|CH_DKV) = (\d+)", text)}


GROUP = _constants()
NQ_DQ, NQ_DKV = GROUP["NQ_DQ"], GROUP["NQ_DKV"]


def window_start(i, size, k):
    return min(max(i - k // 2, 0), size - k)


def start_w(i, size, k, circular):
    return i - k // 2 if circular else window_start(i, size, k)


def window_span(i0, n, size, k, circular):
    if circular:
        return i0 - k // 2, min(n + k - 1, size)
    lo = window_start(i0, size, k)
    return lo, window_start(i0 + n - 1, size, k) + k - lo


def inverse_lo(j, size, k, circular):
    return j - (k - 1 - k // 2) if circular else (0 if j < k else j - (k - 1 - k // 2))


def inverse_hi(j, size, k, circular):
    return j + k // 2 if circular else (size - 1 if j >= size - k else j + k // 2)


def inverse_span(j0, n, size, k, circular):
    lo = inverse_lo(j0, size, k, circular)
    return lo, (min(n + k - 1, size) if circular else inverse_hi(j0 + n - 1, size, k, False) - lo + 1)


def union_index(col, lo, span, w, circular):
    """The kernels' staged column of an unreduced column (clamped: outside
    the union it is masked)."""
    c = col - lo
    if circular and c >= span:
        c -= w
    return min(max(c, 0), span - 1)


def tile_of(dims, kernel, circular, tdims, inverse):
    """A Tile of dims tdims with the host's staged extents."""
    spans = [_max_span(s, k, t, c, inverse) for s, k, t, c in
             zip(dims, kernel, tdims, (False, False, circular))]
    n_tiles = math.prod(-(-s // t) for s, t in zip(dims, tdims))
    return Tile(*tdims, *spans, 0, n_tiles)


def groups(tile, d0, h0, w0, dims, nq):
    """The tile's lane groups: (pd, ph, pw0, live), nq W positions each."""
    for pd, ph in itertools.product(range(tile.td), range(tile.th)):
        for pw0 in range(0, tile.tw, nq):
            yield pd, ph, pw0, d0 + pd < dims[0] and h0 + ph < dims[1]


def origins(dims, tile):
    return itertools.product(range(0, dims[0], tile.td), range(0, dims[1], tile.th),
                             range(0, dims[2], tile.tw))


def flat(dims, d, h, w):
    return (d * dims[1] + h) * dims[2] + w


def dq_walk(dims, kernel, circular, tile):
    """The dq kernel's pairs: (query, key, slot, rel, tile id) per computed
    pair, positions flat in the volume, slot and rel flat."""
    (D, H, W), (kd, kh, kw) = dims, kernel
    nrh, nrw = 2 * kh - 1, 2 * kw - 1
    out = []
    for t_id, (d0, h0, w0) in enumerate(origins(dims, tile)):
        lo_d, sp_d = window_span(d0, min(tile.td, D - d0), D, kd, False)
        lo_h, sp_h = window_span(h0, min(tile.th, H - h0), H, kh, False)
        lo_w, sp_w = window_span(w0, min(tile.tw, W - w0), W, kw, circular)
        assert sp_d <= tile.ud and sp_h <= tile.uh and sp_w <= tile.uw
        for pd, ph, pw0, live in groups(tile, d0, h0, w0, dims, NQ_DQ):
            qd, qh = min(d0 + pd, D - 1), min(h0 + ph, H - 1)
            qw = [min(w0 + pw0 + j, W - 1) for j in range(NQ_DQ)]
            sd, sh = window_start(qd, D, kd), window_start(qh, H, kh)
            cw0 = start_w(qw[0], W, kw, circular)
            for x, y, u in itertools.product(range(kd), range(kh), range(NQ_DQ - 1 + kw)):
                # the plane is copied by the time the kernel waits for x + td - 1
                assert sd + x - lo_d <= min(x + tile.td - 1, sp_d - 1)
                col = cw0 + u
                cu = union_index(col, lo_w, sp_w, W, circular)
                staged = (sd + x, lo_h + sh + y - lo_h, (lo_w + cu) % W)
                for j in range(NQ_DQ):
                    z = col - start_w(qw[j], W, kw, circular)
                    if not (live and w0 + pw0 + j < W and 0 <= z < kw):
                        continue
                    assert staged[2] == col % W, "the staged column is the key's"
                    rel = ((sd + x - qd + kd - 1) * nrh + sh + y - qh + kh - 1) * nrw + col - qw[j] + kw - 1
                    out.append((flat(dims, qd, qh, qw[j]), flat(dims, *staged), (x * kh + y) * kw + z,
                                rel, t_id))
    return out


def dkv_walk(dims, kernel, circular, tile, ry):
    """The dk/dv kernel's pairs: (query, key, rel) per computed pair."""
    (D, H, W), (kd, kh, kw) = dims, kernel
    nrh, nrw = 2 * kh - 1, 2 * kw - 1
    out = []
    for d0, h0, w0 in origins(dims, tile):
        lo_d, sp_d = inverse_span(d0, min(tile.td, D - d0), D, kd, False)
        lo_h, sp_h = inverse_span(h0, min(tile.th, H - h0), H, kh, False)
        lo_w, sp_w = inverse_span(w0, min(tile.tw, W - w0), W, kw, circular)
        assert sp_d <= tile.ud and sp_h <= tile.uh and sp_w <= tile.uw
        strips = -(-sp_h // ry)
        for it in range(sp_d * strips):  # items: a plane's strip of rows
            pd = lo_d + it // strips
            y0 = lo_h + (it % strips) * ry
            y1 = min(y0 + ry, lo_h + sp_h)
            for gd, gh, pw0, live in groups(tile, d0, h0, w0, dims, NQ_DKV):
                jd, jh = min(d0 + gd, D - 1), min(h0 + gh, H - 1)
                kw_ = [min(w0 + pw0 + j, W - 1) for j in range(NQ_DKV)]
                if not (live and inverse_lo(jd, D, kd, False) <= pd <= inverse_hi(jd, D, kd, False)):
                    continue
                qc_lo = inverse_lo(kw_[0], W, kw, circular)
                n_cols = inverse_hi(kw_[-1], W, kw, circular) - qc_lo + 1
                rows = range(max(y0, inverse_lo(jh, H, kh, False)),
                             min(y1, inverse_hi(jh, H, kh, False) + 1))
                for ih, u in itertools.product(rows, range(n_cols)):
                    col = qc_lo + u
                    cu = union_index(col, lo_w, sp_w, W, circular)
                    assert (lo_w + cu) % W == col % W, "the staged query is the one walked"
                    for j in range(NQ_DKV):
                        z = kw_[j] - start_w(col, W, kw, circular)
                        if not (w0 + pw0 + j < W and 0 <= z < kw):
                            continue
                        rel = ((jd - pd + kd - 1) * nrh + jh - ih + kh - 1) * nrw + kw_[j] - col + kw - 1
                        out.append((flat(dims, pd, ih, col % W), flat(dims, jd, jh, kw_[j]), rel))
    return out


def all_pairs(dims, kernel, circular):
    """{(query, key): (slot, rel)} of every window, by brute force."""
    (D, H, W), (kd, kh, kw) = dims, kernel
    nrh, nrw = 2 * kh - 1, 2 * kw - 1
    pairs = {}
    for i in itertools.product(range(D), range(H), range(W)):
        s = (window_start(i[0], D, kd), window_start(i[1], H, kh), start_w(i[2], W, kw, circular))
        for x, y, z in itertools.product(range(kd), range(kh), range(kw)):
            key = flat(dims, s[0] + x, s[1] + y, (s[2] + z) % W)
            rel = ((s[0] + x - i[0] + kd - 1) * nrh + s[1] + y - i[1] + kh - 1) * nrw + s[2] + z - i[2] + kw - 1
            pairs[(flat(dims, *i), key)] = ((x * kh + y) * kw + z, rel)
    return pairs


def slot_table(size, k, t, i0, circular):
    """[2k - 1, t] slot of each tile query at each relative offset, -1 for
    none or a query past the axis (the dq kernel's drpb tables)."""
    table = np.full((2 * k - 1, t), -1)
    for r, qi in itertools.product(range(2 * k - 1), range(t)):
        i = i0 + qi
        if i < size:
            s = r - (k - 1) + k // 2 if circular else i + r - (k - 1) - window_start(i, size, k)
            table[r, qi] = s if 0 <= s < k else -1
    return table


def emulate(q, k, v, rpb, dout, kernel, circular, dq_tile, dkv_tile, ry):
    """dq, dk, dv, drpb computed along the two kernels' walks, f32."""
    _, D, H, W, heads, ch = q.shape
    dims = (D, H, W)
    scale = ch**-0.5
    out, lse = neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular, with_lse=True)
    delta = (dout * out).sum(-1).reshape(-1, heads)
    qf, kf, vf, df = (t.reshape(-1, heads, ch) for t in (q, k, v, dout))
    lsef, rpbf = lse.reshape(-1, heads), rpb.reshape(heads, -1)

    def pair_terms(qi, ki, rel):
        s = (qf[qi] * kf[ki]).sum(-1) * scale + rpbf[:, rel].T
        p = torch.exp(s - lsef[qi])
        return p, p * ((df[qi] * vf[ki]).sum(-1) - delta[qi])

    walk = np.array(dq_walk(dims, kernel, circular, dq_tile))
    qi, ki, slot, rel, t_id = (torch.from_numpy(walk[:, i]) for i in range(5))
    _, ds = pair_terms(qi, ki, rel)
    dq = torch.zeros_like(qf).index_add_(0, qi, ds[..., None] * kf[ki]) * scale
    # drpb: per tile, ds by (tile query, slot), then per offset by the tables.
    n_slots, tq = math.prod(kernel), dq_tile.td * dq_tile.th * dq_tile.tw
    drpb = torch.zeros(heads, rpbf.shape[1])
    for t_id_, (d0, h0, w0) in enumerate(origins(dims, dq_tile)):
        sel = t_id == t_id_
        local = torch.from_numpy(np.array([
            ((d // (H * W) - d0) * dq_tile.th + (d // W % H - h0)) * dq_tile.tw + d % W - w0
            for d in qi[sel].tolist()], dtype=np.int64)).reshape(-1)
        table = torch.zeros(tq * n_slots, heads).index_put_((local * n_slots + slot[sel],), ds[sel])
        tabs = [slot_table(s_, k_, t_, i0, c_) for s_, k_, t_, i0, c_ in zip(
            dims, kernel, (dq_tile.td, dq_tile.th, dq_tile.tw), (d0, h0, w0), (False, False, circular))]
        r_all = np.arange(rpbf.shape[1])
        rd, rh, rw = np.unravel_index(r_all, [2 * kk - 1 for kk in kernel])
        for q_loc in range(tq):
            a, b, c = np.unravel_index(q_loc, (dq_tile.td, dq_tile.th, dq_tile.tw))
            sx, sy, sz = tabs[0][rd, a], tabs[1][rh, b], tabs[2][rw, c]
            ok = (sx >= 0) & (sy >= 0) & (sz >= 0)
            idx = q_loc * n_slots + (sx * kernel[1] + sy) * kernel[2] + sz
            drpb[:, ok] += table[torch.from_numpy(idx[ok])].T
    walk = np.array(dkv_walk(dims, kernel, circular, dkv_tile, ry))
    qi, ki, rel = (torch.from_numpy(walk[:, i]) for i in range(3))
    p, ds = pair_terms(qi, ki, rel)
    dk = torch.zeros_like(kf).index_add_(0, ki, ds[..., None] * qf[qi]) * scale
    dv = torch.zeros_like(vf).index_add_(0, ki, p[..., None] * df[qi])
    return [t.reshape(q.shape) for t in (dq, dk, dv)] + [drpb.reshape(rpb.shape)]


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("dims,kernel,tdims", [
    ((5, 6, 11), (3, 3, 5), (2, 2, 4)),  # clamped and padded tiles, W past a group
    ((6, 9, 12), (5, 7, 7), (2, 4, 4)),
    ((4, 7, 9), (3, 5, 5), None),  # the host's tiles
])
def test_every_pair_once_in_each_kernel(dims, kernel, tdims, circular):
    """Each kernel computes every (query, key) pair of every window exactly
    once, with its window slot (dq) and relative offset; the dk/dv kernel
    also with its inverse window cut into strips of 2 rows."""
    want = all_pairs(dims, kernel, circular)
    if tdims is None:
        dq_tile = _pick_tile("dq", dims, kernel, circular, 8, True)
        dkv_tile = _pick_tile("dkv", dims, kernel, circular, 8, True)
        rys = [_dkv_rows(dkv_tile, kernel, 8)]
    else:
        dq_tile = tile_of(dims, kernel, circular, tdims, False)
        dkv_tile = tile_of(dims, kernel, circular, tdims, True)
        rys = [dkv_tile.uh, 2]
    got = dq_walk(dims, kernel, circular, dq_tile)
    assert len(got) == len(want) and len({(a, b) for a, b, *_ in got}) == len(want)
    assert all(want[(a, b)] == (s, r) for a, b, s, r, _ in got)
    for ry in rys:
        got = dkv_walk(dims, kernel, circular, dkv_tile, ry)
        assert len(got) == len(want) and len({(a, b) for a, b, _ in got}) == len(want)
        assert all(want[(a, b)][1] == r for a, b, r in got)


@pytest.mark.parametrize("kernel,dims,circular", [
    ((3, 3, 5), (4, 6, 10), False),
    ((3, 3, 5), (4, 6, 10), True),
    ((5, 7, 7), (5, 8, 9), False),
])
def test_walks_match_jax_k5b(kernel, dims, circular):
    """dq, dk, dv and drpb along the emulated walks (small tiles: several per
    axis, padded groups, strips of 2 rows) against jax.grad through
    neighborhood_attention_3d_flash in interpret mode (K5b's body), at 4
    heads of 32 (the JAX kernel's heads * ch must fill 128 lanes)."""
    heads, ch = 4, 32
    rng = np.random.default_rng(sum(kernel) + circular)
    q, k, v, dout = (rng.standard_normal((1, *dims, heads, ch)).astype(np.float32) for _ in range(4))
    rpb = (0.5 * rng.standard_normal((heads, *(2 * kk - 1 for kk in kernel)))).astype(np.float32)

    def objective(qq, kk, vv, r):
        out = jax_flash.neighborhood_attention_3d_flash(qq, kk, vv, kernel, r, circular, interpret=True)
        return jnp.sum(out * dout)

    want = jax.grad(objective, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, rpb)))
    dq_tile = tile_of(dims, kernel, circular, (2, 2, 4), False)
    dkv_tile = tile_of(dims, kernel, circular, (2, 2, 4), True)
    got = emulate(*map(torch.from_numpy, (q, k, v, rpb, dout)), kernel, circular, dq_tile, dkv_tile, 2)
    for name, a, b in zip(("dq", "dk", "dv", "drpb"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL, err_msg=name)


def test_window_too_wide_to_stage_reads_through_l1():
    """A W window so wide that one row of the dk/dv kernel's inverse window
    does not fit in shared memory at 128 channels: `takes` still answers
    True, `_dkv_rows` gives 0 (the kernel reads its queries through L1, a
    whole plane an item), and that walk visits every pair once."""
    dims, kernel = (1, 2, 120), (1, 1, 71)
    assert natten_flash.takes((1, *dims, 1, 128), kernel, False, True, backward=True)
    tile = _pick_tile("dkv", dims, kernel, False, 128, True)
    assert _dkv_rows(tile, kernel, 128) == 0
    want = all_pairs(dims, kernel, False)
    got = dkv_walk(dims, kernel, False, tile, tile.uh)
    assert len(got) == len(want) and {(a, b) for a, b, _ in got} == set(want)


# (dims, kernel, circular_w, ch, has_bias) -> takes(backward=True), and the
# fields of _pick_tile's Tile for "fwd", "dq" and "dkv" (None: ValueError),
# as the tree before the dk/dv kernel's staging answered them: the shapes of
# chip_smoke.py (phases 18-24 and 36-40) and of the card and CPU tests.
TILES_BEFORE = [
    ((14, 45, 90), (3, 5, 5), False, 32, True, True, [(2, 8, 8, 4, 12, 12, 167508, 504), (2, 8, 8, 4, 12, 12, 205908, 504), (2, 8, 8, 5, 12, 12, 1620, 504)]),  # noqa: E501
    ((14, 45, 90), (3, 5, 5), True, 32, True, True, [(2, 8, 8, 4, 12, 12, 167508, 504), (2, 8, 8, 4, 12, 12, 205908, 504), (2, 8, 8, 5, 12, 12, 1620, 504)]),  # noqa: E501
    ((14, 45, 90), (5, 7, 7), False, 32, True, True, [(2, 4, 4, 6, 10, 10, 178884, 1932), (2, 4, 4, 6, 10, 10, 210244, 1932), (2, 8, 8, 8, 16, 14, 6084, 504)]),  # noqa: E501
    ((14, 30, 60), (3, 5, 5), False, 32, True, True, [(2, 8, 8, 4, 12, 12, 167508, 224), (2, 8, 8, 4, 12, 12, 205908, 224), (2, 8, 8, 5, 12, 14, 1620, 224)]),  # noqa: E501
    ((14, 45, 90), (5, 7, 7), False, 96, True, False, [None, None, (1, 4, 8, 7, 12, 14, 6084, 2016)]),
    ((14, 15, 30), (5, 7, 7), False, 96, True, False, [None, None, (1, 8, 4, 7, 11, 13, 6084, 224)]),
    ((14, 45, 90), (5, 7, 7), False, 64, True, True, [(1, 2, 4, 5, 8, 10, 223684, 7406), (1, 2, 4, 5, 8, 10, 231524, 7406), (2, 4, 8, 8, 12, 14, 6084, 1008)]),  # noqa: E501
    ((14, 45, 90), (3, 5, 5), False, 128, True, True, [(2, 2, 4, 4, 6, 8, 204372, 3703), (2, 2, 4, 4, 6, 8, 209172, 3703), (1, 8, 4, 4, 12, 10, 1620, 1932)]),  # noqa: E501
    ((14, 45, 90), (5, 7, 7), False, 256, True, False, [None, None, None]),
    ((4, 7, 9), (3, 3, 3), False, 4, True, True, [(4, 8, 4, 4, 7, 6, 27380, 3), (4, 8, 4, 4, 7, 6, 41204, 3), (4, 8, 4, 4, 7, 6, 500, 3)]),  # noqa: E501
    ((4, 7, 9), (3, 5, 5), True, 6, True, True, [(4, 8, 4, 4, 7, 8, 37460, 3), (4, 8, 4, 4, 7, 8, 75860, 3), (4, 8, 4, 4, 7, 8, 1620, 3)]),  # noqa: E501
    ((3, 6, 8), (3, 3, 5), True, 32, False, True, [(4, 2, 8, 3, 4, 8, 28548, 3), (4, 2, 8, 3, 4, 8, 28548, 3), (2, 8, 8, 3, 6, 8, 900, 2)]),  # noqa: E501
    ((3, 6, 8), (3, 3, 5), False, 32, True, True, [(4, 8, 4, 3, 6, 6, 32004, 2), (4, 8, 4, 3, 6, 6, 55044, 2), (2, 8, 8, 3, 6, 8, 900, 2)]),  # noqa: E501
    ((5, 9, 10), (5, 7, 7), False, 64, True, True, [(1, 4, 16, 5, 8, 10, 223684, 15), (2, 1, 16, 5, 7, 10, 227844, 27), (1, 4, 16, 5, 9, 10, 6084, 15)]),  # noqa: E501
    ((3, 5, 12), (3, 3, 5), True, 100, True, True, [(4, 2, 4, 3, 4, 8, 102276, 9), (4, 2, 4, 3, 4, 8, 108036, 9), (1, 8, 4, 3, 5, 8, 900, 9)]),  # noqa: E501
    ((4, 5, 6), (3, 3, 3), True, 8, True, True, [(2, 8, 8, 3, 5, 6, 14900, 2), (2, 8, 8, 3, 5, 6, 28724, 2), (2, 8, 8, 4, 5, 6, 500, 2)]),  # noqa: E501
]


@pytest.mark.parametrize("case", TILES_BEFORE, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-ch{c[3]}")
def test_tiles_and_takes_answer_as_before(case):
    """`takes` and `_pick_tile` give the answers they gave before the dk/dv
    kernel staged its inverse window, so that no shape moves between K5a/K5b,
    K6 and an error; where the backward takes a shape, the dk/dv kernel's
    strips fit (at least one row), and the kernels' CTAs fit 256 threads in
    groups of whole W positions."""
    dims, kernel, circular, ch, has_bias, takes, tiles = case
    shape = (1, *dims, 4, ch)
    if takes:
        assert natten_flash.takes(shape, kernel, circular, has_bias, backward=True)
    else:
        with pytest.raises(ValueError):
            natten_flash.takes(shape, kernel, circular, has_bias, backward=True)
    for kind, want in zip(("fwd", "dq", "dkv"), tiles):
        _pick_tile.cache_clear()
        if want is None:
            with pytest.raises(ValueError):
                _pick_tile(kind, dims, kernel, circular, ch, has_bias)
            continue
        tile = _pick_tile(kind, dims, kernel, circular, ch, has_bias)
        assert tuple(tile.__dict__.values()) == want
        if takes and kind != "fwd":
            cp = natten_flash._padded_width(ch)
            nq, ch_lane = (NQ_DQ, GROUP["CH_DQ"]) if kind == "dq" else (NQ_DKV, GROUP["CH_DKV"])
            assert tile.tw % nq == 0 and tile.td * tile.th * tile.tw // nq * (cp // ch_lane) <= 256
    if takes:
        dkv = _pick_tile("dkv", dims, kernel, circular, ch, has_bias)
        assert 1 <= _dkv_rows(dkv, kernel, ch) <= dkv.uh
