"""The port's banded attention against the JAX package, on the CPU: the band
masks, the DeviceGraph band fields, the plain banded attention, and the
plain twins of K4a/K4b through the port's autograd Function against
banded_flash_attention run as the JAX package's own tests run it on the CPU
(interpret=True).

Graphs are those of tests/test_pallas_kernels.py: random neighbours within
+-w of each receiver, with some receivers left without an edge. Inputs come
from numpy with a seed. Tolerances: atol 2e-5 on outputs and lse (f32
softmax-weighted sums in another order), 2e-4 on gradients (the JAX
package's own limit between its flash and XLA backwards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.meshes.graphs import GraphBundle as JaxGraphBundle
from graph_weather_tpu.nn.graph_blocks import DeviceGraph as JaxDeviceGraph
from graph_weather_tpu.ops.banded_attention import banded_graph_attention as jax_banded
from graph_weather_tpu.ops.banded_attention import build_band_masks as jax_build_band_masks
from graph_weather_tpu.ops.pallas.banded_flash import _flash_impl as jax_flash_impl
from graph_weather_tpu.ops.pallas.banded_flash import banded_flash_attention as jax_banded_flash
from graph_weather_tpu_torch.meshes.graphs import GraphBundle
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
from graph_weather_tpu_torch.ops import banded_flash
from graph_weather_tpu_torch.ops.banded_attention import banded_graph_attention, build_band_masks
from graph_weather_tpu_torch.ops.banded_flash import (
    banded_flash_attention,
    banded_flash_backward_reference,
    banded_flash_forward_reference,
)

torch.set_num_threads(1)
ATOL = 2e-5
GRAD_ATOL = 2e-4
BLOCK = 512


def _graph(rng, n, w, deg=5, empty=()):
    """Random neighbours within +-w of each receiver (test_pallas_kernels.py's
    graph), destination-sorted, without duplicates; `empty` receivers get
    no edge."""
    receivers = np.repeat(np.arange(n), deg)
    lo, hi = np.maximum(0, receivers - w), np.minimum(n, receivers + w + 1)
    senders = lo + (rng.random(receivers.size) * (hi - lo)).astype(np.int64)
    pairs = np.unique(np.stack([receivers, senders], 1), axis=0)
    pairs = pairs[~np.isin(pairs[:, 0], empty)]
    return pairs[:, 1].astype(np.int32), pairs[:, 0].astype(np.int32)


def _inputs(rng, shape, count=3):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("n,w,block", [(1100, 256, 512), (700, 300, 256), (40, 8, 16)])
def test_build_band_masks_matches_jax(n, w, block):
    s, r = _graph(np.random.default_rng(n), n, w, empty=(3,))
    got = build_band_masks(s, r, n, block, w)
    want = jax_build_band_masks(s, r, n, block, w)
    assert got.dtype == want.dtype == bool and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for fn in (build_band_masks, jax_build_band_masks):
        with pytest.raises(ValueError, match="exceeds band half-width"):
            fn(s, r, n, block, w - 1)


@pytest.mark.parametrize("band_flash", [False, True], ids=["banded", "banded_flash"])
def test_device_graph_band_fields_match_jax(band_flash):
    """w rounded to 256 (banded) or 512 (banded_flash) from the span, the
    block, and the masks (int8 here, bool there)."""
    s, r = _graph(np.random.default_rng(5), 1300, 200, empty=(0, 1299))
    arrays = (s, r, np.zeros((s.size, 1), np.float32), 1300, 1300)
    ref = JaxDeviceGraph.from_bundle(JaxGraphBundle(*arrays), banded=True, band_flash=band_flash)
    got = DeviceGraph.from_bundle(GraphBundle(*arrays), "cpu", banded=True, band_flash=band_flash)
    assert (got.band_w, got.band_block, got.band_flash) == (ref.band_w, ref.band_block, ref.band_flash)
    assert got.band_w == (512 if band_flash else 256)
    assert got.band_masks.dtype == torch.int8
    np.testing.assert_array_equal(got.band_masks.numpy() != 0, np.asarray(ref.band_masks))
    plain = DeviceGraph.from_bundle(GraphBundle(*arrays), "cpu")
    assert plain.band_masks is None and plain.band_w == plain.band_block == 0


@pytest.mark.parametrize("batch", [None, 2])
def test_banded_graph_attention_matches_jax(batch):
    """The plain banded attention (the `banded` option) against the JAX
    package's XLA version, with empty receiver rows (exact zeros)."""
    rng = np.random.default_rng(0)
    n, h, c, w = 1100, 2, 32, 256
    empty = [3, 700, 1099]
    s, r = _graph(rng, n, w, empty=empty)
    masks = build_band_masks(s, r, n, BLOCK, w)
    shape = (n, h, c) if batch is None else (batch, n, h, c)
    q, k, v = _inputs(rng, shape)
    want = np.asarray(jax_banded(q, k, v, jnp.asarray(masks), BLOCK, w))
    got = banded_graph_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(masks), BLOCK, w)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert bool((got[..., empty, :, :] == 0).all())


@pytest.mark.parametrize("c", [128, 16])
def test_flash_forward_reference_matches_jax(c):
    """The plain K4a (out and lse) against the Pallas K4a in the interpreter:
    its out, and its lse (broadcast over each head's 128 lanes there)."""
    rng = np.random.default_rng(c)
    n, h, w = 1300, 2, 512
    empty = [0, 511, 512, 1299]
    s, r = _graph(rng, n, w, deg=6, empty=empty)
    masks = build_band_masks(s, r, n, BLOCK, w)
    q, k, v = _inputs(rng, (n, h, c))
    want_out, want_lse = jax_flash_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(masks, jnp.int8),
        BLOCK, w, True, with_lse=True,
    )
    nb = masks.shape[0]
    want_lse = np.asarray(want_lse).reshape(nb * BLOCK, h, 128)[..., 0]
    out, lse = banded_flash_forward_reference(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(masks.astype(np.int8)), BLOCK, w, with_lse=True
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    assert lse.shape == (nb * BLOCK, h)
    real = want_lse > -1e27  # rows with a neighbour; the others hold -1e28 + log(1e-30)
    assert not real[empty].any() and not real[n:].any()
    np.testing.assert_allclose(lse.numpy()[real], want_lse[real], atol=ATOL)
    np.testing.assert_allclose(lse.numpy()[~real], want_lse[~real], rtol=1e-6)
    assert bool((out[empty] == 0).all())
    served = jax_banded_flash(q, k, v, jnp.asarray(masks), BLOCK, w, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(served), atol=ATOL)


@pytest.mark.parametrize(
    "n,w,c", [(1300, 512, 128), (1300, 512, 16), (1100, 256, 64)],
    ids=["w512_c128", "w512_c16", "legacy_w256"],
)
def test_gradients_match_jax(n, w, c):
    """dq, dk, dv of sum(out * cot) through the port's autograd Function
    (plain K4a with lse, plain K4b) against jax.grad of the JAX package's
    banded_flash_attention: its Pallas K4b at w = 512, its XLA VJP at the
    legacy w = 256. Empty rows get exact-zero dq."""
    rng = np.random.default_rng(n + c)
    h = 2
    empty = [0, 511, 512, n - 1]
    s, r = _graph(rng, n, w, deg=6, empty=empty)
    masks = build_band_masks(s, r, n, BLOCK, w)
    q, k, v, cot = _inputs(rng, (n, h, c), 4)

    def loss(q, k, v):
        return jnp.sum(jax_banded_flash(q, k, v, jnp.asarray(masks), BLOCK, w, interpret=True) * cot)

    want = jax.grad(loss, (0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = banded_flash_attention(*leaves, torch.from_numpy(masks.astype(np.int8)), BLOCK, w)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL, err_msg=f"d{name}")
    assert bool((got[0][empty] == 0).all())


def test_batch_matches_per_sample():
    """B = 2 with one shared mask: the plain K4a and K4b and the plain banded
    attention against each sample alone."""
    rng = np.random.default_rng(2)
    n, h, c, w = 900, 2, 16, 256
    s, r = _graph(rng, n, w, empty=(5,))
    masks = torch.from_numpy(build_band_masks(s, r, n, BLOCK, w).astype(np.int8))
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(rng, (2, n, h, c), 4))
    out, lse = banded_flash_forward_reference(q, k, v, masks, BLOCK, w, with_lse=True)
    grads = banded_flash_backward_reference(q, k, v, masks, out, lse, dout, BLOCK, w)
    plain = banded_graph_attention(q, k, v, masks, BLOCK, w)
    for i in range(2):
        out_i, lse_i = banded_flash_forward_reference(q[i], k[i], v[i], masks, BLOCK, w, with_lse=True)
        torch.testing.assert_close(out[i], out_i, rtol=0, atol=1e-6)
        torch.testing.assert_close(lse[i], lse_i, rtol=0, atol=1e-6)
        grads_i = banded_flash_backward_reference(q[i], k[i], v[i], masks, out_i, lse_i, dout[i], BLOCK, w)
        for a, b in zip(grads, grads_i):
            torch.testing.assert_close(a[i], b, rtol=0, atol=1e-6)
        torch.testing.assert_close(plain[i], banded_graph_attention(q[i], k[i], v[i], masks, BLOCK, w),
                                   rtol=0, atol=1e-6)
        torch.testing.assert_close(out[i], plain[i], rtol=0, atol=ATOL)


def test_plain_backward_matches_autograd_of_plain_forward():
    """The written-out backward against torch.autograd through the plain
    forward, and through the plain banded attention (the `banded` option's
    gradient)."""
    rng = np.random.default_rng(3)
    n, h, c, w = 700, 2, 8, 512
    s, r = _graph(rng, n, w, empty=(0, 699))
    masks = torch.from_numpy(build_band_masks(s, r, n, BLOCK, w).astype(np.int8))
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(rng, (n, h, c), 4))
    out, lse = banded_flash_forward_reference(q, k, v, masks, BLOCK, w, with_lse=True)
    got = banded_flash_backward_reference(q, k, v, masks, out, lse, dout, BLOCK, w)
    for forward in (banded_flash_forward_reference, banded_graph_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(forward(*leaves, masks, BLOCK, w), leaves, dout)
        for name, a, b in zip("qkv", got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=f"d{name}")


def test_guards_and_no_launch_on_the_cpu():
    """The JAX contract's "multiples" guard, shape and dtype checks; on the
    CPU the Function runs the twins, so no kernel count moves."""
    q = torch.zeros(600, 1, 128)
    with pytest.raises(ValueError, match="multiples"):
        banded_flash_attention(q, q, q, torch.zeros(2, 512, 712, dtype=torch.int8), 512, 100)
    with pytest.raises(ValueError, match="multiples"):
        banded_flash_attention(q, q, q, torch.zeros(3, 256, 768, dtype=torch.int8), 256, 256)
    with pytest.raises(ValueError, match=r"\[nb, block, block \+ 2w\]"):
        banded_flash_attention(q, q, q, torch.zeros(2, 512, 512, dtype=torch.int8), 512, 256)
    with pytest.raises(ValueError, match="more rows"):
        banded_flash_attention(q, q, q, torch.zeros(1, 512, 1024, dtype=torch.int8), 512, 256)
    with pytest.raises(TypeError, match="float32"):
        banded_flash_attention(q.double(), q.double(), q.double(),
                               torch.zeros(2, 512, 1024, dtype=torch.int8), 512, 256)
    rng = np.random.default_rng(4)
    s, r = _graph(rng, 600, 256)
    masks = torch.from_numpy(build_band_masks(s, r, 600, BLOCK, 256).astype(np.int8))
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _inputs(rng, (600, 2, 8)))
    counts = lambda: (  # noqa: E731
        banded_flash.LAUNCHES, banded_flash.BWD_DQ_LAUNCHES, banded_flash.BWD_DKV_LAUNCHES
    )
    before = counts()
    banded_flash_attention(q, k, v, masks, BLOCK, 256).sum().backward()
    with torch.no_grad():
        banded_flash_attention(q, k, v, masks, BLOCK, 256)
    assert counts() == before
