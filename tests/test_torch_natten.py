"""The port's 3D neighborhood attention against the JAX package, on the CPU.

Both get the same numpy inputs. Tolerances are the JAX package's own
(tests/test_pallas_kernels.py): 2e-5 on the forward and lse (f32 softmax
sums over at most 75 keys in another order), 5e-5 on the gradients. The
Pallas kernels K5a/K5b run in interpret mode, as the JAX package's tests run
them on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.ops import neighborhood_attention as jax_na
from graph_weather_tpu.ops.pallas import natten_flash as jax_flash
from graph_weather_tpu_torch.ops import natten_flash
from graph_weather_tpu_torch.ops.neighborhood_attention import (
    _window_indices,
    neighborhood_attention_3d,
    neighborhood_attention_3d_reference,
)

torch.set_num_threads(1)
FWD_ATOL = 2e-5
GRAD_ATOL = 5e-5


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


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("size,kernel", [(7, 3), (9, 5), (5, 5), (4, 1), (12, 7), (6, 4)])
def test_window_indices_match_jax(size, kernel, circular):
    got = _window_indices(size, kernel, circular)
    want = jax_na._window_indices(size, kernel, circular)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="must be <="):
        _window_indices(kernel - 1, kernel, circular) if kernel > 1 else _window_indices(0, 1, False)


# Every kernel with every (rpb, circular) pair; the head widths alternate so
# that each kernel meets both.
TWIN_CASES = [
    (kernel, with_rpb, circular, *((2, 4) if with_rpb != circular else (4, 32)))
    for kernel in [(3, 3, 3), (1, 3, 3), (3, 5, 5)]
    for with_rpb in (True, False)
    for circular in (False, True)
]


@pytest.mark.parametrize("kernel,with_rpb,circular,heads,ch", TWIN_CASES)
def test_twin_matches_jax_xla(kernel, with_rpb, circular, heads, ch):
    """The plain version against neighborhood_attention_3d_xla on [2, 4, 7, 9]."""
    q, k, v, rpb = _inputs((2, 4, 7, 9), heads, ch, kernel, with_rpb)
    want = jax_na.neighborhood_attention_3d_xla(_j(q), _j(k), _j(v), kernel, _j(rpb), circular)
    got = neighborhood_attention_3d_reference(_t(q), _t(k), _t(v), kernel, _t(rpb), circular)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


def _jax_tile(shape, kernel, circular):
    d, h, w = shape[1:4]
    return next((th, tw) for th, tw in jax_flash._candidate_tiles(d, h, w, kernel, circular)
                if th <= h and tw <= w)


@pytest.mark.parametrize("circular", [False, True])
def test_twin_forward_and_lse_match_k5a_interpret(circular):
    """Forward and log-sum-exp against K5a itself (_flash_fwd_impl with lse,
    interpret mode), at heads * ch = 128 on [1, 3, 6, 8]."""
    kernel = (3, 3, 5)
    q, k, v, rpb = _inputs((1, 3, 6, 8), 4, 32, kernel, True, seed=1)
    th, tw = _jax_tile(q.shape, kernel, circular)
    out, lse = jax_flash._flash_fwd_impl(
        _j(q), _j(k), _j(v), _j(rpb), kernel, circular, th, tw, interpret=True, with_lse=True
    )
    got, got_lse = neighborhood_attention_3d_reference(
        _t(q), _t(k), _t(v), kernel, _t(rpb), circular, with_lse=True
    )
    assert got_lse.shape == (1, 3, 6, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=FWD_ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=FWD_ATOL)


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("with_rpb", [True, False])
def test_gradients_match_k5b_interpret(circular, with_rpb):
    """dq, dk, dv and drpb of the port's plain backward (through the autograd
    Function, as the CPU path runs it) against jax.grad through
    neighborhood_attention_3d_flash in interpret mode (K5b's body)."""
    kernel = (3, 3, 5)
    q, k, v, rpb = _inputs((1, 3, 6, 8), 4, 32, kernel, with_rpb, seed=2)
    g = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)

    def objective(*args):
        qq, kk, vv = args[:3]
        r = args[3] if with_rpb else None
        out = jax_flash.neighborhood_attention_3d_flash(qq, kk, vv, kernel, r, circular, interpret=True)
        return jnp.sum(out * g)

    arrays = [q, k, v] + ([rpb] if with_rpb else [])
    want = jax.grad(objective, argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    r = leaves[3] if with_rpb else None
    out = neighborhood_attention_3d(*leaves[:3], kernel, r, circular)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, b in zip("q k v rpb".split(), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL, err_msg=f"d{name}")


def test_cpu_takes_the_plain_versions():
    """On CPU tensors, forward and backward run the plain versions: the
    forward equals the twin exactly, and no launch counter moves."""
    kernel = (3, 3, 3)
    q, k, v, rpb = (_t(a) for a in _inputs((1, 4, 5, 6), 2, 8, kernel, True, seed=4))
    counts = (natten_flash.LAUNCHES, natten_flash.BWD_DQ_LAUNCHES, natten_flash.BWD_DKV_LAUNCHES)
    out = neighborhood_attention_3d(q, k, v, kernel, rpb, circular_w=True)
    assert torch.equal(out, neighborhood_attention_3d_reference(q, k, v, kernel, rpb, True))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, rpb)]
    out = neighborhood_attention_3d(*leaves[:3], kernel, leaves[3], circular_w=True)
    out.square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
    assert (natten_flash.LAUNCHES, natten_flash.BWD_DQ_LAUNCHES,
            natten_flash.BWD_DKV_LAUNCHES) == counts


def test_argument_errors():
    q = torch.zeros(1, 2, 5, 6, 2, 4)
    with pytest.raises(ValueError, match="must be <="):
        neighborhood_attention_3d(q, q, q, (3, 3, 3))
    with pytest.raises(ValueError, match="rpb"):
        neighborhood_attention_3d(q, q, q, (1, 3, 3), torch.zeros(2, 1, 5, 4))
    with pytest.raises(ValueError, match="one shape"):
        neighborhood_attention_3d(q, q[:, :1], q, (1, 3, 3))
    with pytest.raises(TypeError, match="float32"):
        neighborhood_attention_3d(q.double(), q.double(), q.double(), (1, 3, 3))


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("size,k,tile", [(14, 3, 2), (45, 5, 8), (90, 5, 8), (13, 7, 4), (9, 5, 16)])
def test_tile_spans_cover_every_window(size, k, tile, circular):
    """The host's per-axis spans, which size the kernels' halos: the union of
    a query tile's windows, and the queries whose window holds a key of a
    key tile, against brute-force membership from _window_indices."""
    idx, _ = _window_indices(size, k, circular)
    for i0 in range(0, size, tile):
        i1 = min(i0 + tile, size)
        lo, span = natten_flash._window_span(i0, i1, size, k, circular)
        keys = np.unique(idx[i0:i1])
        assert span == min(len(keys), size) or circular
        assert all((key - lo) % size < span for key in keys)
        lo, span = natten_flash._inverse_span(i0, i1, size, k, circular)
        queries = np.unique(np.nonzero(np.isin(idx, np.arange(i0, i1)).any(1))[0])
        assert span == len(queries)
        assert all((qq - lo) % size < span for qq in queries)
        for j in range(i0, i1):  # one key: at most k + k//2 queries on an axis of 2k or more
            assert np.isin(idx, [j]).any(1).sum() <= (k + k // 2 if size >= 2 * k else size)


def test_tile_choice_fits_shared_memory():
    """WeatherMesh's 1-degree latent and the JAX module's default kernel:
    every kernel has a tile within Hopper's shared memory; ch > 128 or a
    halo that cannot fit raises ValueError."""
    dims = (14, 45, 90)
    for kernel, ch in (((3, 5, 5), 32), ((5, 7, 7), 32), ((5, 7, 7), 64)):
        for kind in ("fwd", "dq", "dkv"):
            tile = natten_flash._pick_tile(kind, dims, kernel, False, ch, True)
            assert tile.smem <= natten_flash.SMEM_LIMIT
            assert tile.td * tile.th * tile.tw <= natten_flash._max_queries(
                natten_flash._padded_width(ch))
    tile = natten_flash._pick_tile("fwd", dims, (3, 5, 5), False, 32, True)
    assert (tile.td, tile.th, tile.tw) == (2, 8, 8)
    with pytest.raises(ValueError, match="shared memory"):
        natten_flash._pick_tile("fwd", dims, (5, 7, 7), False, 128, True)
