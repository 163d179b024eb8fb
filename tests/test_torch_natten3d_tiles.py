"""The tiles of the 3D neighborhood attention forward K6 (csrc/natten3d.cu),
on the CPU.

The kernel gives a CTA `rows` query rows (a warp each) by 128 / lanes
columns of one D plane and stages, one key plane (slab) at a time, the
union of their windows in that plane, in items of at most ry union rows by
rx union columns; a group of lanes owns four W-neighbouring queries and,
for each key row of their window, takes the four windows' union of columns
in chunks of 10, masks the keys outside each query's window (worked out
from coordinates), adds rpb, and runs an online softmax step. `emulate`
below does the same in Python, item by item, row by row and chunk by
chunk, from the tile plan the host computes (ops/natten3d.plan); it is held
against the JAX package's XLA slot scan (neighborhood_attention_3d_xla) at
small sizes, on clamped edges, across the circular seam, with a slab cut
into strips and with a kernel wider than a chunk, and it counts that every
query meets each key of its window exactly once. The tolerance is the JAX
package's own (2e-5: f32 softmax sums over at most 245 keys in another
order).

The second part shows why the other design the kernel was timed against
(scripts/natten3d_mma.cu: tensor-core products) splits each f32 product
into three TF32 products: K6's forward computed with each product rounded
as the tensor cores round it (TF32 emulated in torch), against float64, as
tests/test_torch_clustered_tf32.py does for K3: one TF32 product misses the
card's 1e-4 limit, three keep f32 accuracy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.ops.neighborhood_attention import neighborhood_attention_3d_xla
from graph_weather_tpu_torch.ops import natten3d
from graph_weather_tpu_torch.ops.natten_flash import SMEM_LIMIT

torch.set_num_threads(1)
ATOL = 2e-5
K6_TOL = 1e-4  # chip_smoke.py's limit on K6 against its plain version (K5_TOL)
NEG = -1e30


def window_start(i, size, k):
    return min(max(i - k // 2, 0), size - k)


def start_w(i, w, kw, circular):
    """The window start on the W axis, unreduced on a circular axis."""
    return i - kw // 2 if circular else window_start(i, w, kw)


def tile_union(h0, w0, th, tw, shape, kernel, circular):
    """The kernel's union of a tile's windows in a slab: union rows
    [u0h, u1h) and unreduced columns [u0w, u1w)."""
    _, _, h, w = shape[:4]
    _, kh, kw = kernel
    hl, wl = min(h0 + th, h) - 1, min(w0 + tw, w) - 1
    return (window_start(h0, h, kh), window_start(hl, h, kh) + kh,
            start_w(w0, w, kw, circular), start_w(wl, w, kw, circular) + kw)


def emulate(q, k, v, kernel, rpb, circular):
    """K6's forward as the kernel computes it (see the module docstring), in
    float32; returns (out, the number of window keys each query met)."""
    b_sz, d, h, w, heads, ch = q.shape
    kd, kh, kw = kernel
    plan = natten3d.plan(tuple(q.shape), kernel, circular)
    th, tw = plan.rows, plan.columns
    out = torch.zeros_like(q)
    met = torch.zeros(q.shape[:-1], dtype=torch.long)
    for b in range(b_sz):
        for head in range(heads):
            for qd in range(d):
                sd = window_start(qd, d, kd)
                for h0 in range(0, h, th):
                    for w0 in range(0, w, tw):
                        u0h, u1h, u0w, u1w = tile_union(h0, w0, th, tw, q.shape, kernel, circular)
                        assert u1h - u0h <= natten3d.union_span(h, kh, False, th)
                        assert u1w - u0w <= natten3d.union_span(w, kw, circular, tw)
                        items = [(x, y0, min(y0 + plan.ry, u1h), c0, min(c0 + plan.rx, u1w))
                                 for x in range(kd) for y0 in range(u0h, u1h, plan.ry)
                                 for c0 in range(u0w, u1w, plan.rx)]
                        for qh in range(h0, min(h0 + th, h)):
                            for qw0 in range(w0, min(w0 + tw, w), 4):
                                _group(q, k, v, rpb, kernel, circular, plan, b, head, qd, sd, qh,
                                       qw0, items, out, met)
    return out, met


def _group(q, k, v, rpb, kernel, circular, plan, b, head, qd, sd, qh, qw0, items, out, met):
    """One lane group's four queries (qh, qw0 .. qw0 + 3, repeating the last
    query of the volume past it) over the tile's items."""
    _, d, h, w, _, ch = q.shape
    kd, kh, kw = kernel
    qw = torch.tensor([min(qw0 + j, w - 1) for j in range(4)])[:, None]
    sw = torch.tensor([start_w(int(i), w, kw, circular) for i in qw])[:, None]
    sh = window_start(qh, h, kh)
    qs = q[b, qd, qh, qw[:, 0], head] * ch ** -0.5  # [4, ch]
    m = torch.full((4, 1), NEG)
    l = torch.zeros(4, 1)
    o = torch.zeros(4, ch)
    n_met = torch.zeros(4, dtype=torch.long)
    n_chunks = -(-(3 + kw) // 10)
    for x, y0, y1, c0, c1 in items:
        assert (y1 - y0) * (c1 - c0) <= plan.ry * plan.rx
        for y in range(max(y0, sh), min(y1, sh + kh)):
            for chunk in range(n_chunks):
                cu = int(sw[0]) + 10 * chunk + torch.arange(10)[None]  # unreduced columns
                staged = cu.clamp(c0, c1 - 1)[0]  # a column outside the item reads a staged one
                kk = k[b, sd + x, y, staged % w, head]
                vv = v[b, sd + x, y, staged % w, head]
                s = qs @ kk.T
                valid = (cu >= c0) & (cu < c1) & (cu >= sw) & (cu < sw + kw)
                if rpb is not None:
                    rel_w = (cu - qw + kw - 1).clamp(0, 2 * kw - 2)
                    s = s + rpb[head, sd + x - qd + kd - 1, y - qh + kh - 1][rel_w]
                cmax = torch.where(valid, s, NEG).amax(1, keepdim=True)
                m_new = torch.maximum(m, cmax)
                alpha = torch.exp(m - m_new)
                p = torch.where(valid, torch.exp(s - m_new), 0.0)
                l = l * alpha + p.sum(1, keepdim=True)
                o = o * alpha + p @ vv
                m = m_new
                n_met += valid.sum(1)
    for j in range(4):
        if qw0 + j < w:
            out[b, qd, qh, qw0 + j, head] = o[j] / l[j]
            met[b, qd, qh, qw0 + j, head] = n_met[j]


def _inputs(shape, heads, ch, kernel, with_rpb, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((*shape, heads, ch)).astype(np.float32) for _ in range(3))
    rpb = None
    if with_rpb:
        rpb = (0.5 * rng.standard_normal((heads, *(2 * kk - 1 for kk in kernel)))).astype(np.float32)
    return q, k, v, rpb


# (B, D, H, W), heads, ch, kernel, rpb, circular_w
CASES = [
    ((1, 4, 11, 21), 1, 8, (3, 5, 7), True, True),  # tiles across the seam and the H edge
    ((2, 3, 13, 10), 1, 16, (3, 7, 5), True, False),  # clamped on every axis, batch 2
    ((1, 3, 7, 9), 1, 200, (3, 5, 7), False, True),  # cp 256, 16 lanes: slabs in strips
    ((1, 3, 5, 14), 1, 4, (3, 3, 12), True, False),  # kw 12: two column chunks
]
IDS = ["seam_and_edge", "clamped_batch2", "strips_ch200", "two_chunks"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tile_emulation_matches_jax_slot_scan(case):
    shape, heads, ch, kernel, with_rpb, circular = case
    q, k, v, rpb = _inputs(shape, heads, ch, kernel, with_rpb, seed=ch)
    plan = natten3d.plan((*shape, heads, ch), kernel, circular)
    if ch > 128:
        assert (plan.cp, plan.lanes) == (256, 16) and plan.ry < 7  # 7 union rows, several items
    want = np.asarray(neighborhood_attention_3d_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kernel,
        None if rpb is None else jnp.asarray(rpb), circular))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got, met = emulate(qt, kt, vt, kernel, None if rpb is None else torch.from_numpy(rpb), circular)
    assert bool((met == np.prod(kernel)).all())  # every window key exactly once
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("case", [
    ((1, 14, 45, 90, 8, 96), (5, 7, 7), False),  # the 768-d WeatherMesh's layers
    ((1, 14, 45, 90, 8, 96), (5, 7, 7), True),
    ((1, 14, 45, 90, 4, 32), (3, 5, 5), False),
    ((1, 14, 45, 90, 2, 256), (3, 5, 5), False),
    ((1, 14, 45, 90, 1, 256), (5, 7, 7), False),
    ((1, 120, 120, 120, 2, 8), (31, 31, 31), False),
], ids=["wide", "wide_circular", "wm_1deg", "ch256", "ch256_k577", "k31"])
def test_plans_fit_shared_memory(case):
    """Every tile's union fits the plan's items, two stages of K and V fit
    Hopper's 227 KB, and the 768-d layer takes 8 query rows x 16 columns a
    CTA, eight lanes to a query group, in strips of 5 of the union's
    12 x 22 rows."""
    shape, kernel, circular = case
    plan = natten3d.plan(shape, kernel, circular)
    assert plan.smem <= SMEM_LIMIT and 1 <= plan.rows <= 8 and plan.ry >= 1 and plan.rx >= 1
    assert plan.cp >= shape[-1] and plan.cp % (4 * plan.lanes) == 0 and plan.lanes in (8, 16)
    th, tw = plan.rows, plan.columns
    for h0 in range(0, shape[2], th):
        for w0 in range(0, shape[3], tw):
            u0h, u1h, u0w, u1w = tile_union(h0, w0, th, tw, shape, kernel, circular)
            assert 0 <= u0h < u1h <= shape[2] and u1w - u0w <= tw + kernel[2] - 1
            if not circular:
                assert 0 <= u0w < u1w <= shape[3]
    if shape[-1] == 96:
        assert (plan.cp, plan.lanes, plan.rows, plan.ry, plan.rx) == (96, 8, 8, 5, 22)


# -- Why three TF32 products ----------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as the kernels' split does: integer rounding of the low 13 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def exact(a, b):
    return a * b


def one_tf32(a, b):
    return tf32(a) * tf32(b)


def three_tf32(a, b):
    """small_a big_b + big_a small_b + big_a big_b: each product of TF32
    values is exact in f32, the sums are f32."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return (a_small * b_big + a_big * b_small) + a_big * b_big


def slot_forward(q, k, v, rpb, kernel, mul):
    """The clamped forward slot by slot with an online softmax, every
    product of q.k and of p.v taken through `mul` (in q's dtype)."""
    _, d, h, w, _, ch = q.shape
    scale = ch ** -0.5
    m = torch.full(q.shape[:-1], NEG, dtype=q.dtype)
    l = torch.zeros(q.shape[:-1], dtype=q.dtype)
    acc = torch.zeros_like(q)
    tables = []
    for size, kk in zip((d, h, w), kernel):
        i = np.arange(size)[:, None]
        idx = np.clip(i - kk // 2, 0, size - kk) + np.arange(kk)[None]
        tables.append((torch.as_tensor(idx), torch.as_tensor(idx - i + kk - 1)))
    (id_, rd), (ih, rh), (iw, rw) = tables
    for x in range(kernel[0]):
        for y in range(kernel[1]):
            for z in range(kernel[2]):
                kg = k[:, id_[:, x]][:, :, ih[:, y]][:, :, :, iw[:, z]]
                vg = v[:, id_[:, x]][:, :, ih[:, y]][:, :, :, iw[:, z]]
                logits = mul(q, kg).sum(-1) * scale
                bias = rpb[:, rd[:, x]][:, :, rh[:, y]][:, :, :, rw[:, z]].permute(1, 2, 3, 0)
                logits = logits + bias
                m_new = torch.maximum(m, logits)
                alpha, p = torch.exp(m - m_new), torch.exp(logits - m_new)
                l = l * alpha + p
                acc = acc * alpha[..., None] + mul(p[..., None].expand_as(vg), vg)
                m = m_new
    return acc / l[..., None]


@pytest.mark.parametrize("heads,ch,kernel", [(4, 96, (5, 7, 7)), (4, 32, (3, 5, 5))],
                         ids=["wide_96", "wm_32"])
def test_split_tf32_keeps_f32_accuracy(heads, ch, kernel):
    """At [1, 6, 9, 10] against float64: three TF32 products stay within a
    tenth of the 1e-4 limit (as f32 does), one TF32 product misses it."""
    q, k, v, rpb = (torch.from_numpy(a) for a in _inputs((1, 6, 9, 10), heads, ch, kernel, True))
    want = slot_forward(*(t.double() for t in (q, k, v, rpb)), kernel, exact)
    errs = {name: (slot_forward(q, k, v, rpb, kernel, mul).double() - want).abs().max().item()
            for name, mul in (("f32", exact), ("one", one_tf32), ("three", three_tf32))}
    assert errs["three"] <= K6_TOL / 10 and errs["f32"] <= K6_TOL / 10
    assert errs["one"] > K6_TOL
