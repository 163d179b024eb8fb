"""The port's GenCast denoiser with banded attention against the JAX package,
on the CPU: attention_impl="banded" (plain PyTorch here, XLA there) and
"banded_flash" (the plain K4a/K4b here, the Pallas kernels in the
interpreter there), serving and training.

Both packages get the same weights (a flax tree -> convert.from_jax_params)
and the same numpy inputs. Sizes are those of the JAX package's banded
denoiser tests (tests/test_gencast.py): a 32 x 16 grid, splits 2, 3 hops,
widths 16, 2 blocks, 2 heads, with 8 output channels (with 2, the decoder's
LayerNorm over 2 channels amplifies f32 order differences to ~1e-3, as
tests/test_torch_gencast.py notes; at 8 the packages agree to ~1e-6).
Tolerances: the conv alone atol 2e-5; the denoiser's output atol 1e-4; the
loss rtol 1e-5 and each gradient within 1e-3 of its tensor's max|g|
(tests/test_torch_gencast_train.py's limits), at splits 3.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from graph_weather_tpu.models.gencast import Denoiser as JaxDenoiser
from graph_weather_tpu.models.gencast import modules as jax_modules
from graph_weather_tpu.models.gencast.weighted_mse_loss import WeightedMSELoss as JaxWeightedMSELoss
from graph_weather_tpu_torch import (
    Denoiser,
    WeightedMSELoss,
    from_jax_params,
    make_optimizer,
    make_train_step,
)
from graph_weather_tpu_torch.ops import banded_flash, clustered_flash
from test_torch_gencast import CLUSTERED, _close, _rand, _t
from test_torch_gencast_train import (
    _assert_grads_close,
    _batch,
    _jax_value_and_grad,
    _port_value_and_grad,
)

torch.set_num_threads(1)
IMPLS = ["banded", "banded_flash"]
BANDED = {**CLUSTERED, "num_hops": 3, "output_features_dim": 8}
SPLITS3 = {**BANDED, "splits": 3}


def _counts():
    return (banded_flash.LAUNCHES, banded_flash.BWD_DQ_LAUNCHES, banded_flash.BWD_DKV_LAUNCHES,
            clustered_flash.LAUNCHES)


def _numpy_params(ref, seed=0):
    """Random weights for the JAX Denoiser, drawn in numpy on the shapes of
    jax.eval_shape (flax's init would compile the whole model): kernels
    ~N(0, 1/fan_in), biases ~N(0, 0.1^2), LayerNorm scales ~1 + N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "kernel" in name:
            return x / np.sqrt(leaf.shape[0])
        return 1.0 + 0.1 * x if "scale" in name else 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _models(kw, impl):
    kw = {**kw, "attention_impl": impl}
    ref = JaxDenoiser(**kw)
    params = _numpy_params(ref)
    port = Denoiser(**kw, device="cpu")
    port.module.load_state_dict(from_jax_params(params))
    return ref, port, params


@pytest.fixture(scope="module", params=IMPLS)
def banded_models(request):
    return (request.param, *_models(BANDED, request.param))


def test_band_layout_matches_jax(banded_models):
    """The lat-lon sorted k-hop graph's band fields, as the JAX package
    builds them (w 512 for banded_flash, 256 for banded)."""
    impl, ref, port, _ = banded_models
    khop = port.khop
    assert khop.cluster_ids is None and khop.band_flash == (impl == "banded_flash")
    assert (khop.band_block, khop.band_w) == (ref.khop.band_block, ref.khop.band_w)
    np.testing.assert_array_equal(khop.band_masks.numpy() != 0, np.asarray(ref.khop.band_masks))


@pytest.mark.parametrize("block", [0, 1], ids=["concat_c8", "last_c16"])
def test_transformer_conv_banded_matches_jax(banded_models, block):
    """The banded branch of GraphTransformerConv at c = 8 (concatenated
    heads) and c = 16 (the last block), batch 2."""
    _, ref, port, params = banded_models
    p = params["params"]["GenCastProcessor_0"][f"CondTransformerBlock_{block}"]
    last = block == 1
    conv = jax_modules.GraphTransformerConv(16 if last else 8, 2, concat=not last, use_edge_features=False)
    x = _rand(np.random.default_rng(block), 2, ref.khop.n_receivers, 16)
    want = jax.jit(lambda x: conv.apply({"params": p["GraphTransformerConv_0"]}, x, ref.khop))(x)
    port_conv = getattr(port.module.GenCastProcessor_0, f"CondTransformerBlock_{block}").GraphTransformerConv_0
    _close(port_conv(_t(x), port.khop), want)


def test_denoiser_banded_matches_jax(banded_models):
    """One request (B = 2) through the whole denoiser; on the CPU no kernel
    count moves."""
    _, ref, port, params = banded_models
    rng = np.random.default_rng(7)
    tgt, prev = _rand(rng, 2, 32, 16, 8), _rand(rng, 2, 32, 16, 6)
    noise = np.asarray([[0.5], [2.0]], np.float32)
    want = np.asarray(jax.jit(ref.forward_fn())(params, tgt, prev, noise))
    before = _counts()
    got = port(tgt, prev, noise).numpy()
    assert _counts() == before
    assert got.shape == want.shape == (2, 32, 16, 8)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("impl", IMPLS)
def test_denoiser_banded_gradients_and_train_step_match_jax(impl):
    """forward_fn + WeightedMSELoss + backward against jax.value_and_grad of
    the JAX package's (its Pallas K4b in the interpreter for banded_flash),
    at splits 3 with 8 output channels; then one make_train_step step on a
    fresh model with the same weights: loss and gradient norm against the
    JAX package's, every parameter moves, no kernel launch on the CPU."""
    ref, port, params = _models(SPLITS3, impl)
    assert port.khop.band_masks.shape[0] == 2  # 642 mesh nodes in 512-row blocks
    corrupted, prev, noise, target = _batch(np.random.default_rng(1), SPLITS3, batch=2)
    grid_lat = SPLITS3["grid_lat"]
    want_loss, want_grads = _jax_value_and_grad(
        ref, params, corrupted, prev, noise, target, JaxWeightedMSELoss(grid_lat=grid_lat)
    )
    loss_fn = WeightedMSELoss(grid_lat=grid_lat, device="cpu")
    got_loss, got_grads = _port_value_and_grad(port, corrupted, prev, noise, target, loss_fn)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    _assert_grads_close(got_grads, want_grads)

    fresh = Denoiser(**{**SPLITS3, "attention_impl": impl}, device="cpu")
    fresh.module.load_state_dict(port.module.state_dict())
    before = {k: v.clone() for k, v in fresh.module.state_dict().items()}
    noise_t = torch.from_numpy(noise)
    step = make_train_step(
        fresh.module.parameters(), fresh.forward_fn(), lambda p, t: loss_fn(p, noise_t, t),
        make_optimizer(1e-4), return_grad_norm=True,
    )
    counts = _counts()
    loss, norm = step(*(torch.from_numpy(a) for a in (corrupted, prev, noise, target)))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(want_grads)), rtol=1e-5)
    after = fresh.module.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert _counts() == counts
