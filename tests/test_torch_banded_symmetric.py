"""The symmetric role of the banded attention backward K4b, on the CPU.

For a symmetric edge set, K4b's dk/dv kernel (csrc/banded_flash_bwd.cu,
role DKV_SYM) gives key block b the same window of receivers and the same
mask rows as the dq kernel: key b * block + o is attended by receiver
b * block - w + j exactly when masks[b, o, j] is set. These tests hold that
identity on GenCast's real splits-5 layout, check that DeviceGraph sets
`band_symmetric` only for such graphs, hold the gradients of
banded_flash_attention(..., symmetric=True) (its plain twins on the CPU)
against jax.grad of the JAX package's banded attention (its Pallas K4b in
interpret mode) on a symmetric band, and pin the share of the band's pairs
that lie in 16 x 16 tiles holding an edge, which the kernel's warps skip
to. Inputs come from numpy with a seed; the gradient tolerance is
tests/test_torch_banded.py's (2e-4, the JAX package's own limit between
its flash and XLA backwards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.ops.pallas.banded_flash import banded_flash_attention as jax_banded_flash
from graph_weather_tpu_torch.meshes.clustering import is_symmetric_edges
from graph_weather_tpu_torch.meshes.graphs import GraphBundle
from graph_weather_tpu_torch.models.gencast.graphs import build_graphcast_graphs
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
from graph_weather_tpu_torch.ops.banded_attention import build_band_masks
from graph_weather_tpu_torch.ops.banded_flash import banded_flash_attention

torch.set_num_threads(1)
GRAD_ATOL = 2e-4
BLOCK = 512


@pytest.fixture(scope="module")
def khop():
    """GenCast's k-hop graph at splits 5 (4 hops), lat-lon sorted, with its
    band layout for the flash kernels (chip_smoke.py phase 26)."""
    graphs = build_graphcast_graphs(
        np.arange(0.0, 360.0, 360.0 / 128), np.linspace(-90.0, 90.0, 64), splits=5,
        num_hops=4, add_edge_features_to_khop=False, spatial_sort=True,
    )
    return graphs.khop, DeviceGraph.from_bundle(graphs.khop, "cpu", banded=True, band_flash=True)


def _symmetric_graph(rng, n, w, deg=3, empty=()):
    """Random neighbours within +-w, each edge with its reverse; `empty`
    nodes without any edge."""
    receivers = np.repeat(np.arange(n), deg)
    senders = np.clip(receivers + rng.integers(-w, w + 1, receivers.size), 0, n - 1)
    pairs = np.concatenate([np.stack([receivers, senders], 1), np.stack([senders, receivers], 1)])
    pairs = np.unique(pairs, axis=0)
    pairs = pairs[~np.isin(pairs, empty).any(1)]
    return pairs[:, 1].astype(np.int32), pairs[:, 0].astype(np.int32)


def test_device_graph_sets_band_symmetric(khop):
    """True on the k-hop graph (senders and receivers one node set, every
    edge with its reverse); False once one edge loses its reverse, and on a
    bipartite graph of two node sets."""
    bundle, graph = khop
    assert graph.band_symmetric and graph.band_flash
    assert (graph.band_block, graph.band_w, tuple(graph.band_masks.shape)) == (512, 1024, (21, 512, 2560))
    assert bundle.n_edges == 613_500
    s, r = _symmetric_graph(np.random.default_rng(0), 1300, 300)
    attr = np.zeros((s.size, 1), np.float32)
    sym = DeviceGraph.from_bundle(GraphBundle(s, r, attr, 1300, 1300), "cpu", banded=True)
    assert sym.band_symmetric
    keep = ~((s == s[0]) & (r == r[0]))  # drop one edge, keep its reverse
    directed = DeviceGraph.from_bundle(
        GraphBundle(s[keep], r[keep], attr[keep], 1300, 1300), "cpu", banded=True
    )
    assert not directed.band_symmetric
    bipartite = DeviceGraph.from_bundle(GraphBundle(s, r, attr, 1300, 1301), "cpu", banded=True)
    assert not bipartite.band_symmetric
    assert not DeviceGraph.from_bundle(GraphBundle(s, r, attr, 1300, 1300), "cpu").band_symmetric


def test_mask_rows_are_the_key_major_band(khop):
    """The identity the symmetric dk/dv pass rests on, on the real layout:
    masks[b] read row by row (key o of block b against window slot j) is the
    key-major band, whose bit (b, o, j) is set where receiver
    b * block - w + j attends key b * block + o."""
    bundle, graph = khop
    masks = graph.band_masks.numpy() != 0
    nb, block, width = masks.shape
    w = graph.band_w
    s, r = bundle.senders.astype(np.int64), bundle.receivers.astype(np.int64)
    key_major = np.zeros_like(masks)
    b = s // block
    key_major[b, s - b * block, r - b * block + w] = True
    np.testing.assert_array_equal(key_major, masks)
    assert is_symmetric_edges(bundle.senders, bundle.receivers)


def test_tile_shares_of_the_band(khop):
    """The share of the band's (receiver, slot) pairs in tiles that hold an
    edge: 47.8% at the 64 x 64 tiles of the earlier kernel, 38.3% at the
    16 x 16 warp tiles of K4b (the pairs it computes), 34.3% at 16 x 8; the
    mask's density 2.23%."""
    _, graph = khop
    m = graph.band_masks.bool()
    nb, block, width = m.shape

    def share(tq, tk):
        return m.reshape(nb, block // tq, tq, width // tk, tk).any(4).any(2).float().mean().item()

    assert round(share(64, 64), 3) == 0.478
    assert round(share(16, 16), 3) == 0.383
    assert round(share(16, 8), 3) == 0.343
    assert round(m.float().mean().item(), 4) == 0.0223


@pytest.mark.parametrize("c", [16, 64])
def test_symmetric_gradients_match_jax(c):
    """dq, dk, dv of sum(out * cot) through banded_flash_attention(...,
    symmetric=True) (the plain twins of K4a and K4b on the CPU) against
    jax.grad of the JAX package's banded_flash_attention in interpret mode,
    on a symmetric band (n = 1300, w = 512) with nodes without an edge,
    whose gradients are exactly 0; the flag does not change the result."""
    rng = np.random.default_rng(c)
    n, h, w = 1300, 2, 512
    empty = [0, 511, 512, n - 1]
    s, r = _symmetric_graph(rng, n, w, empty=empty)
    assert is_symmetric_edges(s, r)
    masks = build_band_masks(s, r, n, BLOCK, w)
    q, k, v, cot = (rng.standard_normal((n, h, c)).astype(np.float32) for _ in range(4))

    def loss(q, k, v):
        return jnp.sum(jax_banded_flash(q, k, v, jnp.asarray(masks), BLOCK, w, interpret=True) * cot)

    want = jax.grad(loss, (0, 1, 2))(q, k, v)
    grads = []
    for symmetric in (True, False):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = banded_flash_attention(*leaves, torch.from_numpy(masks.astype(np.int8)), BLOCK, w,
                                     symmetric=symmetric)
        grads.append(torch.autograd.grad(out, leaves, torch.from_numpy(cot)))
    for name, a, b, other in zip("qkv", grads[0], want, grads[1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL, err_msg=f"d{name}")
        assert torch.equal(a, other)
        assert bool((a[empty] == 0).all())
