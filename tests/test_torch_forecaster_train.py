"""The port's forecaster training path against the JAX package, on the CPU.

The `forecaster_small` config (tests/test_torch_forecaster.py) at the 30° and
4° grids: both packages get the same weights (flax init ->
convert.from_jax_params) and the same numpy batch. Every edge update runs
the fused edge update's plain versions here (ops/fused_mlp.py), forward and
backward. Tolerances:
  * NormalizedMSELoss(normalize=True) of forward_fn: rtol 1e-5;
  * each parameter's gradient within 1e-3 of that tensor's max|g| (floored
    at 1e-6 of the largest gradient), as tests/test_torch_gencast_train.py;
  * one make_train_step step (clip + AdamW at lr 1e-3) against the JAX
    package's make_train_step with optax: the parameters within atol 1e-6;
  * use_checkpointing=True: bit-equal gradients.
"""

import jax
import numpy as np
import pytest
import torch

from graph_weather_tpu.models import forecast as jax_forecast
from graph_weather_tpu.models.losses import NormalizedMSELoss as JaxLoss
from graph_weather_tpu.train.optim import make_optimizer as jax_make_optimizer
from graph_weather_tpu.train.step import make_train_step as jax_make_train_step
from graph_weather_tpu_torch import (
    GraphWeatherForecaster,
    NormalizedMSELoss,
    from_jax_params,
    make_optimizer,
    make_train_step,
)
from graph_weather_tpu_torch.ops import edge_mlp, fused_mlp
from test_torch_forecaster import CONFIG, _grid

torch.set_num_threads(1)
FEATURES, AUX = CONFIG["feature_dim"], CONFIG["aux_dim"]


@pytest.fixture(scope="module", params=[30.0, 4.0], ids=["grid30", "grid4"])
def reference(request):
    """The JAX package's loss and gradients of NormalizedMSELoss(normalize=
    True) o forward_fn() on a seeded batch of 2, its parameters after one
    train step, and a port forecaster with the same weights."""
    lat_lons = _grid(request.param)
    ref = jax_forecast.GraphWeatherForecaster(lat_lons, **CONFIG)
    variables = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(int(request.param))
    x = rng.normal(size=(2, len(lat_lons), FEATURES + AUX)).astype(np.float32)
    y = rng.normal(size=(2, len(lat_lons), FEATURES)).astype(np.float32)
    variance = rng.uniform(0.5, 2.0, FEATURES).astype(np.float32)
    loss = JaxLoss(variance, lat_lons, normalize=True)
    fwd = ref.forward_fn()
    value, grads = jax.jit(jax.value_and_grad(lambda v: loss(fwd(v, x), y)))(variables)
    optimizer = jax_make_optimizer(learning_rate=1e-3)
    step = jax.jit(jax_make_train_step(fwd, loss, optimizer))
    stepped, _, _ = step(variables, optimizer.init(variables), x, y)
    return dict(
        lat_lons=lat_lons, variables=variables, x=x, y=y, variance=variance,
        loss=float(value), grads=from_jax_params(jax.tree_util.tree_map(np.asarray, grads)),
        stepped=from_jax_params(jax.tree_util.tree_map(np.asarray, stepped)),
    )


def _port(ref, **kw):
    model = GraphWeatherForecaster(ref["lat_lons"], **CONFIG, **kw, device="cpu")
    model.module.load_state_dict(from_jax_params(ref["variables"]))
    loss = NormalizedMSELoss(ref["variance"], ref["lat_lons"], normalize=True, device="cpu")
    return model, loss


def _value_and_grad(model, loss, ref):
    model.module.zero_grad(set_to_none=True)
    value = loss(model.forward_fn()(torch.from_numpy(ref["x"])), torch.from_numpy(ref["y"]))
    value.backward()
    return value.item(), {k: p.grad for k, p in model.module.named_parameters()}


def test_loss_and_gradients_match_jax(reference):
    model, loss = _port(reference)
    value, grads = _value_and_grad(model, loss, reference)
    np.testing.assert_allclose(value, reference["loss"], rtol=1e-5)
    want = reference["grads"]
    assert set(grads) == set(want)
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for name, g in grads.items():
        limit = max(1e-3 * want[name].abs().max().item(), floor)
        err = (g - want[name]).abs().max().item()
        assert err <= limit, f"{name}: {err} > {limit}"


def test_train_step_matches_optax(reference):
    """One make_train_step step (make_optimizer(1e-3): clip 1, AdamW) from the
    same weights: every parameter within 1e-6 of the JAX package's after its
    make_train_step with optax; the CPU path launches no kernel."""
    model, loss = _port(reference)
    launches = (edge_mlp.LAUNCHES, fused_mlp.LAUNCHES, fused_mlp.BACKWARD_LAUNCHES)
    step = make_train_step(model.module.parameters(), model.forward_fn(), loss, make_optimizer(1e-3))
    value = step(torch.from_numpy(reference["x"]), torch.from_numpy(reference["y"]))
    np.testing.assert_allclose(value.item(), reference["loss"], rtol=1e-5)
    after = model.module.state_dict()
    for name, want in reference["stepped"].items():
        np.testing.assert_allclose(after[name].numpy(), want.numpy(), atol=1e-6, err_msg=name)
    assert (edge_mlp.LAUNCHES, fused_mlp.LAUNCHES, fused_mlp.BACKWARD_LAUNCHES) == launches


def test_checkpointing_gives_bit_equal_gradients(reference):
    """use_checkpointing=True (torch.utils.checkpoint per processor block)
    against the same weights without it."""
    plain, loss = _port(reference)
    remat, _ = _port(reference, use_checkpointing=True)
    assert remat.module.Processor_0.GraphProcessor_0.remat
    want = _value_and_grad(plain, loss, reference)
    got = _value_and_grad(remat, loss, reference)
    assert got[0] == want[0]
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])


def test_bf16_policy_raises():
    """forward_fn takes float32 and bfloat16 (tests/test_torch_forecaster_bf16.py
    holds the bf16 policy to the JAX package's); other compute dtypes raise,
    naming the queued TF32 policy."""
    model = GraphWeatherForecaster(_grid(30.0), **CONFIG, device="cpu")
    assert callable(model.forward_fn(compute_dtype=torch.float32))
    features = torch.zeros(1, len(model.lat_lons), FEATURES + AUX)
    with torch.no_grad():
        out = model.forward_fn(compute_dtype=torch.bfloat16)(features)
    assert out.dtype == torch.float32 and out.shape == (1, len(model.lat_lons), FEATURES)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(NotImplementedError, match="ROADMAP.md, 'TF32 compute policy'"):
            model.forward_fn(compute_dtype=dtype)
