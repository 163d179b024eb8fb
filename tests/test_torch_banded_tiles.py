"""The tiles of the banded attention forward K4a (csrc/banded_flash.cu), on
the CPU.

The kernel gives a CTA 16 RG receiver rows of one block (a warp, or CS warps,
per 16 rows) and walks the block's window of keys in copied tiles of TK keys;
before any copy it scans the CTA's mask bytes once into per-warp 16 x 16
tile bits, copies only the tiles in which some row group has an edge, and
computes in each only the 16-key warp tiles in which its rows have one: an
online softmax over those warp tiles, tile by tile, with each warp tile's
p . v products in a fresh accumulator added to the output. `emulate_k4a`
below does the same in plain torch, from the kernel's tile configurations,
and is held against the JAX package's K4a (`_flash_impl` in interpret mode,
as tests/test_torch_banded.py runs it) for out and lse, with rows without an
edge and padded rows exactly 0 (their lse -1e28 + log(1e-30)); it counts
that every edge is visited once. The second part pins the shares of the
real splits-5 band's pairs that the tile sizes compute (chip_smoke.py phase
26). Tolerance: 2e-5, the JAX package's (f32 softmax sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.ops.pallas.banded_flash import _flash_impl as jax_flash_impl
from graph_weather_tpu_torch.models.gencast.graphs import build_graphcast_graphs
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
from graph_weather_tpu_torch.ops.banded_attention import build_band_masks

torch.set_num_threads(1)
ATOL = 2e-5
BLOCK = 512
SUB = 16  # keys of a warp tile
NEG, SAFE = -1e30, -1e28
EMPTY_LSE = np.float32(SAFE) + np.float32(np.log(np.float32(1e-30)))


def k4a_config(c):
    """(RG row groups of a CTA, TK keys of a copied tile) of the kernel's
    instantiation for head width c (banded_flash.cu: W32 .. W512)."""
    for cp, rg, tk in ((32, 8, 64), (128, 8, 32), (256, 4, 16), (512, 2, 16)):
        if c <= cp:
            return rg, tk
    raise ValueError(c)


def scan_edges(masks_b, a0, rg_count):
    """The CTA's warp-tile bits from one read of its mask rows: [RG, n_sub,
    16, 16] bool (rows past the block have none) and the per-warp flags."""
    rows = masks_b[a0:a0 + 16 * rg_count] != 0  # [16 RG, width]
    width = rows.shape[1]
    bits = rows.reshape(rg_count, 16, width // SUB, SUB).permute(0, 2, 1, 3)
    return bits, bits.any(-1).any(-1)


def emulate_k4a(q, k, v, masks, block, w, visits=None):
    """K4a's walk in plain torch: q, k, v [B, n, h, c] f32, masks [nb, block,
    block + 2w]. Returns (out [B, n, h, c], lse [B, nb * block, h]); counts
    each (receiver, slot) pair it computes on an edge into `visits`."""
    bsz, n, h, c = q.shape
    nb, _, width = masks.shape
    rg_count, tk = k4a_config(c)
    ns = tk // SUB
    scale = 1.0 / c**0.5
    n_pad = nb * block
    q_p = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, n_pad - n))
    k_p, v_p = (torch.nn.functional.pad(t, (0, 0, 0, 0, w, n_pad - n + w)) for t in (k, v))
    out = torch.zeros(bsz, n_pad, h, c)
    lse = torch.zeros(bsz, n_pad, h)
    for b in range(nb):
        for a0 in range(0, block, 16 * rg_count):
            bits, flags = scan_edges(masks[b], a0, rg_count)
            tiles = [t for t in range(width // tk) if flags[:, t * ns:(t + 1) * ns].any()]
            for rg in range(rg_count):
                r0 = b * block + a0 + 16 * rg
                qr = q_p[:, r0:r0 + 16]  # [B, 16, h, c]
                m_i = torch.full((bsz, h, 16), SAFE)
                l_i = torch.zeros(bsz, h, 16)
                o = torch.zeros(bsz, h, 16, c)
                for t in tiles:
                    act = [j for j in range(ns) if flags[rg, t * ns + j]]
                    if not act:
                        continue
                    s = {}
                    for j in act:  # row products of the active warp tiles
                        k0 = b * block + t * tk + j * SUB  # padded key row of slot t tk + 16 j
                        logits = torch.einsum("bqhc,bkhc->bhqk", qr, k_p[:, k0:k0 + SUB]) * scale
                        s[j] = torch.where(bits[rg, t * ns + j], logits, torch.tensor(NEG))
                        if visits is not None:
                            visits[b, a0 + 16 * rg:a0 + 16 * rg + 16,
                                   t * tk + j * SUB:t * tk + (j + 1) * SUB] += bits[rg, t * ns + j].int()
                    mx = torch.stack([s[j].amax(-1) for j in act]).amax(0)
                    m_new = torch.maximum(m_i, mx)
                    alpha = torch.exp(m_i - m_new)
                    l_i = l_i * alpha
                    o = o * alpha[..., None]
                    m_i = m_new
                    for j in act:
                        p = torch.exp(s[j] - m_i[..., None])
                        l_i = l_i + p.sum(-1)
                        k0 = b * block + t * tk + j * SUB
                        # a fresh accumulator per warp tile, added in f32
                        o = o + torch.einsum("bhqk,bkhc->bhqc", p, v_p[:, k0:k0 + SUB])
                l_safe = torch.clamp(l_i, min=1e-30)
                out[:, r0:r0 + 16] = (o / l_safe[..., None]).permute(0, 2, 1, 3)
                lse[:, r0:r0 + 16] = (m_i + torch.log(l_safe)).transpose(1, 2)
    return out[:, :n], lse


def _graph(rng, n, w, deg=6, empty=()):
    """Random neighbours within +-w (tests/test_torch_banded.py's graph);
    `empty` receivers get no edge."""
    receivers = np.repeat(np.arange(n), deg)
    lo, hi = np.maximum(0, receivers - w), np.minimum(n, receivers + w + 1)
    senders = lo + (rng.random(receivers.size) * (hi - lo)).astype(np.int64)
    pairs = np.unique(np.stack([receivers, senders], 1), axis=0)
    pairs = pairs[~np.isin(pairs[:, 0], empty)]
    return pairs[:, 1].astype(np.int32), pairs[:, 0].astype(np.int32)


@pytest.mark.parametrize("c", [16, 128, 200, 512])
def test_emulated_walk_matches_jax_k4a(c):
    """The emulated walk against the Pallas K4a in the interpreter, B = 1,
    2 heads, n = 1300 (padded rows in the last block), w = 512, every head
    width class (TK = 64, 32, 16 with 8, 8, 4, 2 row groups); rows without
    an edge and padded rows come out exactly 0 with lse -1e28 + log(1e-30),
    and every edge is computed exactly once."""
    rng = np.random.default_rng(c)
    n, h, w = 1300, 2, 512
    empty = [0, 17, 511, 512, 1299]
    s, r = _graph(rng, n, w, empty=empty)
    masks = build_band_masks(s, r, n, BLOCK, w)
    q, k, v = (rng.standard_normal((n, h, c)).astype(np.float32) for _ in range(3))
    want_out, want_lse = jax_flash_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(masks, jnp.int8),
        BLOCK, w, True, with_lse=True,
    )
    nb = masks.shape[0]
    want_lse = np.asarray(want_lse).reshape(nb * BLOCK, h, -1)[..., 0]
    tmasks = torch.from_numpy(masks.astype(np.int8))
    visits = torch.zeros(masks.shape, dtype=torch.int32)
    out, lse = emulate_k4a(*(torch.from_numpy(t)[None] for t in (q, k, v)), tmasks, BLOCK, w, visits)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(want_out), atol=ATOL)
    real = want_lse > -1e27
    assert not real[empty].any() and not real[n:].any()
    np.testing.assert_allclose(lse[0].numpy()[real], want_lse[real], atol=ATOL)
    assert (lse[0].numpy()[~real] == EMPTY_LSE).all()
    assert bool((out[0, empty] == 0).all())
    assert torch.equal(visits, torch.from_numpy(masks.astype(np.int32)))


def test_warp_with_one_edge_in_the_last_subtile():
    """A receiver whose only edge is in the last 16 keys of its window (the
    last warp tile of the last copied tile), and a block without any edge:
    the walk reaches the one, and leaves the other at exact zeros."""
    n, h, c, w = 1024, 1, 32, 512
    receivers = np.array([511, 600])
    senders = np.array([511 + w, 600])  # window slot 1535 of block 0: its last
    masks = build_band_masks(senders, receivers, n, BLOCK, w)
    assert masks[0].nonzero()[1].tolist() == [BLOCK + 2 * w - 1]
    masks[1] = False  # block 1 without any edge
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, h, c)).astype(np.float32)) for _ in range(3))
    out, lse = emulate_k4a(q, k, v, torch.from_numpy(masks.astype(np.int8)), BLOCK, w)
    torch.testing.assert_close(out[0, 511], v[0, 511 + w], atol=1e-6, rtol=0)
    assert bool((out[0, :511] == 0).all())
    assert bool((out[0, 512:] == 0).all()) and bool((lse[0, 512:] == float(EMPTY_LSE)).all())


@pytest.fixture(scope="module")
def band():
    """GenCast's k-hop graph at splits 5 (4 hops), lat-lon sorted, in the
    band layout of the flash kernels (chip_smoke.py phase 26)."""
    graphs = build_graphcast_graphs(
        np.arange(0.0, 360.0, 360.0 / 128), np.linspace(-90.0, 90.0, 64), splits=5,
        num_hops=4, add_edge_features_to_khop=False, spatial_sort=True,
    )
    return DeviceGraph.from_bundle(graphs.khop, "cpu", banded=True, band_flash=True)


def test_tile_shares_of_the_band(band):
    """The share of the band's (receiver, slot) pairs in tiles that hold an
    edge, at each tile size: 47.8% at the 64 x 64 tiles of the FP32 design
    before, 44.2% at 32 x 32, 38.3% at the 16 x 16 warp tiles the kernel
    computes (from the emulated scan), 34.3% at 16 x 8, 27.7% at 8 x 8; and
    the share of the copied 128-row x 32-key tiles (c = 128) the CTAs copy."""
    m = band.band_masks.bool()
    nb, block, width = m.shape
    assert (nb, block, width) == (21, 512, 2560)

    def share(tq, tk):
        return m.reshape(nb, block // tq, tq, width // tk, tk).any(4).any(2).float().mean().item()

    assert [round(share(t, u), 3) for t, u in ((64, 64), (32, 32), (16, 16), (16, 8), (8, 8))] == [
        0.478, 0.442, 0.383, 0.343, 0.277]
    rg_count, tk = k4a_config(128)
    computed = copied = 0
    for b in range(nb):
        for a0 in range(0, block, 16 * rg_count):
            _, flags = scan_edges(band.band_masks[b], a0, rg_count)
            computed += int(flags.sum()) * 256
            copied += int(flags.reshape(rg_count, -1, tk // SUB).any(-1).any(0).sum())
    assert round(computed / m.numel(), 3) == 0.383
    assert round(copied * 16 * rg_count * tk / m.numel(), 3) == pytest.approx(share(128, 32), abs=1e-3)
