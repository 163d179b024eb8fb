"""The port's GenCast training path against the JAX package, on the CPU.

Both packages get the same weights (a flax tree -> convert.from_jax_params)
and the same numpy inputs. Tolerances:
  * WeightedMSELoss: rtol 1e-6 (f32 reductions in another order);
  * the denoiser's loss: rtol 1e-5; its gradients per tensor within
    1e-3 * max|g| of that tensor (floored at 1e-6 of the largest gradient,
    for the exactly-zero ones). The decoder ends in a LayerNorm over the
    output channels, which amplifies f32 order differences between the two
    packages to a few 1e-4 of the output at 2 channels (PERF.md §6),
    and the gradients pass back through it: see SPLITS3;
  * the optimizer on the same gradients: 1e-6 on the parameters after 3
    steps; the schedule: rtol 1e-6 (optax computes in f32);
  * remat: bit-equal gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graph_weather_tpu.models.gencast import Denoiser as JaxDenoiser
from graph_weather_tpu.models.gencast.noise import sample_noise_level as jax_sample_noise_level
from graph_weather_tpu.models.gencast.weighted_mse_loss import WeightedMSELoss as JaxWeightedMSELoss
from graph_weather_tpu.train.optim import cosine_warmup_schedule as jax_schedule
from graph_weather_tpu.train.optim import make_optimizer as jax_make_optimizer
from graph_weather_tpu_torch import (
    Denoiser,
    WeightedMSELoss,
    cosine_warmup_schedule,
    from_jax_params,
    make_optimizer,
    make_train_step,
)
from graph_weather_tpu_torch.models.gencast import noise_level_from_uniform, sample_noise_level
from graph_weather_tpu_torch.ops import clustered_flash
from test_torch_gencast import CLUSTERED, GENCAST_GOLDEN, _golden_kwargs, _golden_params

torch.set_num_threads(1)
# The clustered test config at splits 3 (642 mesh nodes: nb = 3 at block
# 256), with 8 output channels: with its 2, the decoder's LayerNorm over 2
# channels makes the gradients so ill-conditioned that the JAX package's own
# jit and eager gradients differ by up to 9e-3 of a tensor's max|g| at random
# weights; at 8 the port and the JAX package agree to ~3e-6 of it.
SPLITS3 = {**CLUSTERED, "splits": 3, "output_features_dim": 8}


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _batch(rng, kw, batch=1):
    n_lon, n_lat = len(kw["grid_lon"]), len(kw["grid_lat"])
    f_in, f_out = kw["input_features_dim"], kw["output_features_dim"]
    corrupted, prev, target = (
        _rand(rng, batch, n_lon, n_lat, f) for f in (f_out, 2 * f_in, f_out)
    )
    noise = np.asarray([[0.7], [3.0]][:batch], np.float32)
    return corrupted, prev, noise, target


def _models(kw, params=None):
    ref = JaxDenoiser(**kw)
    if params is None:
        params = ref.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    port = Denoiser(**kw, device="cpu")
    port.module.load_state_dict(from_jax_params(params))
    return ref, port, params


@pytest.mark.parametrize("weights", ["area", "area_features"])
def test_weighted_mse_loss_matches_jax(weights):
    rng = np.random.default_rng(0)
    lat = np.linspace(-90.0, 90.0, 16)
    extra = {}
    if weights == "area_features":
        extra = dict(pressure_levels=np.array([500.0, 850.0]), num_atmospheric_features=2,
                     single_features_weights=np.array([1.0, 0.5]))
    pred, target = _rand(rng, 2, 32, 16, 6), _rand(rng, 2, 32, 16, 6)
    noise = np.array([[0.5], [4.0]], np.float32)
    want = float(JaxWeightedMSELoss(grid_lat=lat, **extra)(jnp.asarray(pred), jnp.asarray(noise), jnp.asarray(target)))
    loss = WeightedMSELoss(grid_lat=lat, **extra, device="cpu")
    got = loss(torch.from_numpy(pred), torch.from_numpy(noise), torch.from_numpy(target)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_weighted_mse_loss_errors():
    t = torch.zeros(2, 32, 16, 3)
    noise = torch.ones(2, 1)
    with pytest.raises(ValueError, match="all three"):
        WeightedMSELoss(pressure_levels=np.ones(2), device="cpu")
    loss = WeightedMSELoss(grid_lat=np.linspace(-90, 90, 8), device="cpu")
    with pytest.raises(ValueError, match="same shape"):
        loss(t, noise, t[..., :2])
    with pytest.raises(ValueError, match="batch, lon, lat, var"):
        loss(t[0], noise, t[0])
    with pytest.raises(ValueError, match="noise levels"):
        loss(t, noise[:1], t)
    with pytest.raises(ValueError, match="grid_lat size"):
        loss(t, noise, t)
    feats = WeightedMSELoss(pressure_levels=np.ones(2), num_atmospheric_features=1,
                            single_features_weights=np.ones(2), device="cpu")
    with pytest.raises(ValueError, match="features weights size"):
        feats(t, noise, t)


def _jax_value_and_grad(ref, params, corrupted, prev, noise, target, loss):
    fwd = ref.forward_fn()

    def objective(p):
        return loss(fwd(p, corrupted, prev, noise), jnp.asarray(noise), jnp.asarray(target))

    return jax.jit(jax.value_and_grad(objective))(params)


def _port_value_and_grad(port, corrupted, prev, noise, target, loss):
    port.module.zero_grad(set_to_none=True)
    fwd = port.forward_fn()
    value = loss(fwd(corrupted, prev, noise), torch.from_numpy(noise), torch.from_numpy(target))
    value.backward()
    return value.item(), {k: p.grad for k, p in port.module.named_parameters()}


def _assert_grads_close(got, want_tree):
    """Per tensor within 1e-3 * max|g| of that tensor, and at least 1e-6 of
    the model's largest gradient: the k projection's bias has an exactly-zero
    gradient (a shift of every key's logit cancels in the softmax), so both
    packages give rounding noise there."""
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(got) == set(want)
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for name, g in got.items():
        limit = max(1e-3 * want[name].abs().max().item(), floor)
        err = (g - want[name]).abs().max().item()
        assert err <= limit, f"{name}: {err} > {limit}"


def _reference(kw, params=None):
    """The JAX package's loss and gradients on a seeded batch of 2, and a
    port Denoiser with the same weights."""
    ref, port, params = _models(kw, params)
    batch = _batch(np.random.default_rng(1), kw, batch=2)
    loss, grads = _jax_value_and_grad(ref, params, *batch, JaxWeightedMSELoss(grid_lat=kw["grid_lat"]))
    return port, batch, float(loss), grads


@pytest.fixture(scope="module")
def splits3():
    return _reference(SPLITS3)


@pytest.mark.parametrize("config", ["clustered_splits3", "segment_golden"])
def test_denoiser_loss_and_gradients_match_jax(config, splits3):
    """forward_fn + WeightedMSELoss + backward against jax.value_and_grad of
    the JAX package's forward_fn + WeightedMSELoss: the clustered path (the
    plain K3a and K3c here, the Pallas kernels in the interpreter there) at
    splits 3, and the segment path with edge features on the golden's
    weights."""
    if config == "segment_golden":
        data = np.load(GENCAST_GOLDEN)
        kw = _golden_kwargs(data)
        port, batch, want_loss, want_grads = _reference(kw, _golden_params(data))
    else:
        kw = SPLITS3
        port, batch, want_loss, want_grads = splits3
        assert port.khop.cluster_ids.shape[0] == 3 and port.khop.cluster_symmetric
    got_loss, got_grads = _port_value_and_grad(
        port, *batch, WeightedMSELoss(grid_lat=kw["grid_lat"], device="cpu")
    )
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    _assert_grads_close(got_grads, want_grads)


def test_train_step_matches_jax(splits3):
    """One make_train_step step on a fresh model with the same weights: its
    loss and its gradient norm before clipping against the JAX package's
    (optax.global_norm, as its train step reports it); every parameter
    moves; on the CPU the step makes no kernel launch."""
    reference, (corrupted, prev, noise, target), want_loss, want_grads = splits3
    port = Denoiser(**SPLITS3, device="cpu")
    port.module.load_state_dict(reference.module.state_dict())
    before = {k: v.clone() for k, v in port.module.state_dict().items()}
    launches = clustered_flash.LAUNCHES, clustered_flash.SYMMETRIC_DQ_LAUNCHES
    loss_fn = WeightedMSELoss(grid_lat=SPLITS3["grid_lat"], device="cpu")
    noise_t = torch.from_numpy(noise)
    step = make_train_step(
        port.module.parameters(), port.forward_fn(), lambda p, t: loss_fn(p, noise_t, t),
        make_optimizer(1e-4), return_grad_norm=True,
    )
    loss, norm = step(*(torch.from_numpy(a) for a in (corrupted, prev, noise, target)))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(want_grads)), rtol=1e-5)
    after = port.module.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert (clustered_flash.LAUNCHES, clustered_flash.SYMMETRIC_DQ_LAUNCHES) == launches


@pytest.mark.parametrize("clip", ["clipping", "no_clipping"])
def test_optimizer_matches_optax(clip):
    """The same numpy gradients for 3 steps into make_optimizer and into the
    JAX package's optax chain, with a warmup schedule; gradient norms above
    the clip of 1 (clipping) or below it."""
    rng = np.random.default_rng(3)
    shapes = {"w": (5, 4), "b": (4,), "ln": (3,)}
    params = {k: _rand(rng, *s) for k, s in shapes.items()}
    scale = 2.0 if clip == "clipping" else 0.01
    grads = [{k: scale * _rand(rng, *s) for k, s in shapes.items()} for _ in range(3)]
    schedule = jax_schedule(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    opt = jax_make_optimizer(schedule)
    state, want = opt.init(params), dict(params)
    for g in grads:
        updates, state = opt.update(g, state, want)
        want = optax.apply_updates(want, updates)
    leaves = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    port_opt = make_optimizer(cosine_warmup_schedule(peak_lr=1e-2, warmup_steps=2, total_steps=10))(
        leaves.values()
    )
    norms = []
    for g in grads:
        for k, p in leaves.items():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(port_opt.step().item())
    assert (min(norms) > 1.0) if clip == "clipping" else (max(norms) < 1.0)
    for k, p in leaves.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), atol=1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 7"):
        make_optimizer(accumulate_steps=2)


def test_schedule_matches_optax():
    kw = dict(peak_lr=3e-3, warmup_steps=100, total_steps=1000, end_lr_ratio=0.1)
    want, got = jax_schedule(**kw), cosine_warmup_schedule(**kw)
    for step in (0, 1, 50, 100, 101, 550, 1000, 1200):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    assert got(0) == 0.0


def test_remat_gives_bit_equal_gradients():
    """remat=True (torch.utils.checkpoint per transformer block) against
    remat=False on the same weights and batch."""
    _, plain, params = _models(CLUSTERED)
    remat = Denoiser(**CLUSTERED, remat=True, device="cpu")
    remat.module.load_state_dict(from_jax_params(params))
    corrupted, prev, noise, target = _batch(np.random.default_rng(4), CLUSTERED)
    loss = WeightedMSELoss(grid_lat=CLUSTERED["grid_lat"], device="cpu")
    want = _port_value_and_grad(plain, corrupted, prev, noise, target, loss)
    got = _port_value_and_grad(remat, corrupted, prev, noise, target, loss)
    assert got[0] == want[0]
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])


def test_noise_level_map_matches_jax():
    """The u -> sigma map on JAX's own uniform draw gives JAX's noise levels;
    sample_noise_level draws from the generator it is given."""
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (64,)))
    want = np.asarray(jax_sample_noise_level(key, (64,)))
    np.testing.assert_allclose(noise_level_from_uniform(torch.tensor(u)).numpy(), want, rtol=1e-5)
    first = sample_noise_level(torch.Generator().manual_seed(0), (4, 1))
    again = sample_noise_level(torch.Generator().manual_seed(0), (4, 1))
    assert first.shape == (4, 1) and torch.equal(first, again)
    assert bool(((first >= 0.02) & (first <= 88.0)).all())
