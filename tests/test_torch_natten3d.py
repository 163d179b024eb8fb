"""The port's wide-head NATTEN (K6, ops/natten3d.py) and the `impl=`
dispatcher of ops/neighborhood_attention.py against the JAX package, on the
CPU.

Both get the same numpy inputs. The tolerance is the JAX package's own
(tests/test_pallas_kernels.py::TestNatten3DPallas): 2e-5, f32 softmax sums
over at most 245 keys in another order. The Pallas kernels run in interpret
mode, as the JAX package's tests run them on the CPU. On CPU tensors every
impl takes the plain version; which kernel a CUDA tensor would take is a
pure host function (`route`), checked here without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.ops import neighborhood_attention as jax_na
from graph_weather_tpu.ops.pallas.natten3d import neighborhood_attention_3d_pallas
from graph_weather_tpu_torch.ops import natten3d, natten_flash
from graph_weather_tpu_torch.ops.neighborhood_attention import (
    neighborhood_attention_3d,
    neighborhood_attention_3d_reference,
    route,
)

torch.set_num_threads(1)
ATOL = 2e-5


def _inputs(shape, heads, ch, kernel, with_rpb, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((*shape, heads, ch)).astype(np.float32) for _ in range(3))
    rpb = None
    if with_rpb:
        rpb = (0.5 * rng.standard_normal((heads, *(2 * kk - 1 for kk in kernel)))).astype(np.float32)
    return q, k, v, rpb


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# (B, D, H, W), heads, ch, kernel, rpb, circular_w
K6_CASES = [
    ((1, 5, 7, 8), 4, 96, (5, 7, 7), True, False),
    ((1, 5, 7, 8), 4, 96, (5, 7, 7), True, True),
    ((2, 4, 6, 10), 2, 64, (3, 3, 5), True, False),
    ((2, 4, 6, 10), 2, 64, (3, 3, 5), False, False),
]
K6_IDS = ["k577_96_clamped", "k577_96_circular", "k335_64_rpb", "k335_64_no_rpb"]


@pytest.mark.parametrize("case", K6_CASES, ids=K6_IDS)
def test_slot_module_matches_jax_k6_interpret(case):
    """impl="pallas" (K6's module; its plain version on the CPU) against the
    JAX package's K6, neighborhood_attention_3d_pallas in interpret mode."""
    shape, heads, ch, kernel, with_rpb, circular = case
    q, k, v, rpb = _inputs(shape, heads, ch, kernel, with_rpb)
    want = neighborhood_attention_3d_pallas(
        _j(q), _j(k), _j(v), kernel, _j(rpb), circular, interpret=True
    )
    got = neighborhood_attention_3d(_t(q), _t(k), _t(v), kernel, _t(rpb), circular, impl="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    direct = natten3d.neighborhood_attention_3d_slot(_t(q), _t(k), _t(v), kernel, _t(rpb), circular)
    assert torch.equal(direct, got)


@pytest.mark.parametrize("impl", ["auto", "flash", "pallas", "xla"])
def test_every_impl_matches_the_jax_dispatcher(impl):
    """Each impl against the JAX dispatcher with the same impl, on [1, 3, 6,
    8] x 4 x 32 at (3, 3, 5) with rpb, a shape both packages' kernels take
    (the JAX "flash" and "pallas" run in interpret mode on the CPU)."""
    kernel = (3, 3, 5)
    q, k, v, rpb = _inputs((1, 3, 6, 8), 4, 32, kernel, True, seed=1)
    want = jax_na.neighborhood_attention_3d(_j(q), _j(k), _j(v), kernel, _j(rpb), False, impl=impl)
    got = neighborhood_attention_3d(_t(q), _t(k), _t(v), kernel, _t(rpb), False, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cpu_takes_the_plain_version_under_every_impl():
    """CPU tensors: every impl gives the plain version's output exactly and
    launches nothing; a gradient flows through impl="pallas" too."""
    kernel = (3, 3, 3)
    q, k, v, rpb = (_t(a) for a in _inputs((1, 4, 5, 6), 2, 8, kernel, True, seed=2))
    want = neighborhood_attention_3d_reference(q, k, v, kernel, rpb, True)
    before = (natten3d.LAUNCHES, natten_flash.LAUNCHES)
    for impl in ("auto", "flash", "pallas", "xla"):
        assert torch.equal(neighborhood_attention_3d(q, k, v, kernel, rpb, True, impl=impl), want)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, rpb)]
    out = neighborhood_attention_3d(*leaves[:3], kernel, leaves[3], True, impl="pallas")
    out.square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
    assert (natten3d.LAUNCHES, natten_flash.LAUNCHES) == before


# shape, kernel, needs_grad, impl -> what a CUDA tensor takes
ROUTES = [
    ((1, 14, 45, 90, 8, 96), (5, 7, 7), False, "auto", "slot"),  # the 768-d WeatherMesh
    ((1, 14, 45, 90, 4, 32), (3, 5, 5), False, "auto", "flash"),  # the 128-d WeatherMesh
    ((1, 14, 45, 90, 4, 32), (3, 5, 5), True, "auto", "flash"),
    ((1, 14, 45, 90, 2, 256), (3, 5, 5), False, "auto", "slot"),
    ((1, 14, 45, 90, 4, 32), (3, 5, 5), False, "pallas", "slot"),
    ((1, 14, 45, 90, 8, 96), (5, 7, 7), True, "xla", "plain"),
    ((1, 14, 45, 90, 8, 96), (5, 7, 7), False, "xla", "plain"),
    ((1, 14, 45, 90, 8, 96), (5, 7, 7), True, "auto", "slot"),  # training it: K6 and K6b
    ((1, 14, 45, 90, 4, 32), (3, 5, 5), True, "pallas", "slot"),
]


@pytest.mark.parametrize("shape,kernel,needs_grad,impl,want", ROUTES)
def test_route_of_each_impl(shape, kernel, needs_grad, impl, want):
    assert route(shape, kernel, False, True, needs_grad, impl) == want


def test_route_refusals():
    """A gradient through a K6 shape routes to K6 and its backward K6b
    ("slot"), unless K6b's tiles do not fit; "flash" and "pallas" raise
    ValueError naming the limit of the kernel they name; an unknown impl
    raises ValueError in the dispatcher too."""
    wide = (1, 14, 45, 90, 8, 96)
    assert route(wide, (5, 7, 7), False, True, True, "auto") == "slot"
    assert route((1, 14, 45, 90, 4, 32), (3, 5, 5), False, True, True, "pallas") == "slot"
    huge = (1, 1, 61, 61, 1, 8)  # a (1, 61, 61) window with rpb: K6 serves it, K6b cannot
    assert route(huge, (1, 61, 61), False, True, False, "auto") == "slot"
    with pytest.raises(ValueError, match="no backward tile"):
        route(huge, (1, 61, 61), False, True, True, "auto")
    with pytest.raises(ValueError, match="shared memory"):
        route(wide, (5, 7, 7), False, True, False, "flash")
    with pytest.raises(ValueError, match="head width 257 > 256"):
        route((1, 14, 45, 90, 2, 257), (3, 5, 5), False, True, False, "auto")
    with pytest.raises(ValueError, match="exceeds the volume"):
        natten3d.takes((1, 4, 6, 10, 2, 8), (5, 3, 3), False, False)
    with pytest.raises(ValueError, match="shared memory"):
        natten3d.takes((1, 120, 120, 120, 2, 8), (31, 31, 31), False, True)
    assert natten3d.takes((1, 120, 120, 120, 2, 8), (31, 31, 31), False, False)
    with pytest.raises(ValueError, match="unknown impl"):
        route(wide, (5, 7, 7), False, True, False, "triton")
    q = torch.zeros(1, 3, 5, 6, 2, 4)
    with pytest.raises(ValueError, match="unknown impl"):
        neighborhood_attention_3d(q, q, q, (1, 3, 3), impl="natten")
