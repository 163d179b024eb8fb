"""The port's WeatherMesh against the reference golden and the JAX package,
on the CPU.

Both packages get the same weights (the JAX package's variables through
convert.weathermesh_from_jax, or the reference state_dict of the golden as
it is) and the same numpy inputs. Tolerances:
  * the `weathermesh_small` golden: per-variable RMSE < 1e-5, as the JAX
    package's own parity test (tests/test_parity.py);
  * outputs against the JAX model: 1e-4 (two conv paths, GroupNorm's
    variance, which flax takes as E[x^2] - E[x]^2, and attention in another
    summation order); the conv blocks alone: 1e-5;
  * gradients of bench.py's objective: each tensor within 1e-4 of its
    max|g|, floored at 1e-6 of the largest gradient;
  * one train step (clip + AdamW at lr 1e-4): parameters within 1e-5.

The small config's GroupNorms hold one channel per group. With random
linear and conv biases, the decoder's identity conv gives channels that are
nearly constant over the tiny grid, where flax's E[x^2] - E[x]^2 loses
~1e-3 of the output in f32 (the port is closer to the JAX model run in
float64 than the JAX model in f32 is). The tests therefore zero those
biases; their gradients are still compared.
"""

import contextlib
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.models.weathermesh import WeatherMesh as JaxWeatherMesh
from graph_weather_tpu.models.weathermesh import model as jax_model
from graph_weather_tpu.train import make_optimizer as jax_make_optimizer
from graph_weather_tpu.train import make_train_step as jax_make_train_step
from graph_weather_tpu_torch import (
    WeatherMesh,
    WeatherMeshConfig,
    make_optimizer,
    make_train_step,
    weathermesh_from_jax,
)
from graph_weather_tpu_torch.convert import _wm_block_state
from graph_weather_tpu_torch.models.weathermesh import (
    ConvDownBlock,
    ConvUpBlock,
    WeatherMeshDecoderConfig,
    WeatherMeshEncoderConfig,
    WeatherMeshProcessorConfig,
)
from graph_weather_tpu_torch.models.weathermesh import model as wm_model
from graph_weather_tpu_torch.ops import natten3d, natten_flash

torch.set_num_threads(1)
GOLDEN = "tests/goldens/weathermesh_small.npz"
# Two processors, 2 conv blocks each side (H, W divisible by 4), latent
# [1, 4, 4, 6] x 16 with 2 heads of 8, kernel (3, 3, 3).
SMALL = dict(
    timesteps=[0, 1], surface_channels=3, pressure_channels=2, pressure_levels=3,
    latent_dim=16, encoder_num_conv_blocks=2, encoder_num_transformer_layers=1,
    encoder_hidden_dim=4, decoder_num_conv_blocks=2, decoder_num_transformer_layers=1,
    decoder_hidden_dim=4, processor_num_layers=1, kernel=(3, 3, 3), num_heads=2,
)
GRID = (16, 24)
# Heads of 96 at the JAX module's default kernel (5, 7, 7), which the card's
# K5a cannot tile and K6 takes: one processor, 4 levels (latent depth 5), a
# 28 x 28 grid (latent 7 x 7), latent 192 in 2 heads.
WIDE = dict(
    timesteps=[0], surface_channels=3, pressure_channels=2, pressure_levels=4,
    latent_dim=192, encoder_num_conv_blocks=2, encoder_num_transformer_layers=1,
    encoder_hidden_dim=4, decoder_num_conv_blocks=2, decoder_num_transformer_layers=1,
    decoder_hidden_dim=4, processor_num_layers=1, kernel=(5, 7, 7), num_heads=2,
)
WIDE_GRID = (28, 28)


def _golden_model(data):
    (c2, c3, levels, latent_dim, hidden_dim, ncb, ntl, pnl, n_proc,
     kd, kh, kw, heads, steps) = (int(v) for v in data["__config__"])
    model = WeatherMesh(
        timesteps=list(range(n_proc)), surface_channels=c2, pressure_channels=c3,
        pressure_levels=levels, latent_dim=latent_dim, encoder_num_conv_blocks=ncb,
        encoder_num_transformer_layers=ntl, encoder_hidden_dim=hidden_dim,
        decoder_num_conv_blocks=ncb, decoder_num_transformer_layers=ntl,
        decoder_hidden_dim=hidden_dim, processor_num_layers=pnl, kernel=(kd, kh, kw),
        num_heads=heads, norm="batch", device="cpu",
    )
    return model, steps


def test_weathermesh_matches_torch_reference_golden():
    """The reference state_dict loads with load_state_dict as it is (no
    converter), and the outputs match the reference's: BatchNorm in
    inference mode, NATTEN layers, two processors, the decoder."""
    data = np.load(GOLDEN)
    model, steps = _golden_model(data)
    sd = {k: torch.from_numpy(np.asarray(data[k])) for k in data.files if not k.startswith("__")}
    model.module.load_state_dict(sd)
    model.module.eval()
    surface = np.transpose(data["__surface__"], (0, 2, 3, 1))
    pressure = np.transpose(data["__pressure__"], (0, 2, 3, 4, 1))
    out = model(torch.from_numpy(surface), torch.from_numpy(pressure), steps)
    got_s = out.surface.permute(0, 3, 1, 2).numpy()
    got_p = out.pressure.permute(0, 4, 1, 2, 3).numpy()
    exp_s, exp_p = data["__output_surface__"], data["__output_pressure__"]
    assert got_s.shape == exp_s.shape and got_p.shape == exp_p.shape
    rmse_s = np.sqrt(((got_s - exp_s) ** 2).mean(axis=(0, 2, 3)))
    rmse_p = np.sqrt(((got_p - exp_p) ** 2).mean(axis=(0, 2, 3, 4)))
    assert rmse_s.max() < 1e-5, rmse_s
    assert rmse_p.max() < 1e-5, rmse_p


def _batch(rng, batch=1, cfg=SMALL, grid=GRID):
    h, w = grid
    surface = rng.standard_normal((batch, h, w, cfg["surface_channels"])).astype(np.float32)
    pressure = rng.standard_normal(
        (batch, cfg["pressure_levels"], h, w, cfg["pressure_channels"])
    ).astype(np.float32)
    return surface, pressure


def _jax_shapes(model, surface, pressure):
    """The variable tree of a JAX WeatherMesh, as shapes (traced, not compiled)."""
    return jax.eval_shape(
        lambda key: model.init(key, jnp.asarray(surface), jnp.asarray(pressure), 1),
        jax.random.PRNGKey(0),
    )


def _models(cfg, grid):
    """The JAX model at `cfg` with GroupNorm, variables for it drawn in numpy
    (kernels uniform in +-1/sqrt(fan_in), norm scales 1, rpb ~N(0, 0.3^2)
    so that the bias is exercised, linear and conv biases 0: see the module
    docstring), a batch and targets on `grid`, and the port model with the
    same weights."""
    ref = JaxWeatherMesh(**cfg)
    rng = np.random.default_rng(0)
    surface, pressure = _batch(rng, cfg=cfg, grid=grid)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            bound = np.prod(leaf.shape[:-1]) ** -0.5
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if name == "rpb":
            return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (np.ones if name == "scale" else np.zeros)(leaf.shape, np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, _jax_shapes(ref, surface, pressure))
    port = WeatherMesh(**cfg, device="cpu")
    port.module.load_state_dict(weathermesh_from_jax(variables, len(cfg["timesteps"])))
    targets = _batch(rng, cfg=cfg, grid=grid)
    return ref, variables, port, (surface, pressure), targets


@pytest.fixture(scope="module")
def small():
    return _models(SMALL, GRID)


@pytest.fixture(scope="module")
def wide():
    return _models(WIDE, WIDE_GRID)


def test_converter_produces_every_key(small):
    """weathermesh_from_jax gives every key of the port's state_dict and no
    other, with the port's shapes, for GroupNorm and for BatchNorm."""
    _, variables, port, (surface, pressure), _ = small
    state = weathermesh_from_jax(variables, num_processors=2)
    want = port.module.state_dict()
    assert set(state) == set(want)
    assert all(state[k].shape == want[k].shape for k in want)
    bn_shapes = _jax_shapes(JaxWeatherMesh(**SMALL, norm="batch"), surface, pressure)
    bn_vars = jax.tree_util.tree_map(lambda t: np.ones(t.shape, t.dtype), bn_shapes)
    bn_port = WeatherMesh(**SMALL, norm="batch", device="cpu")
    bn_state = weathermesh_from_jax(bn_vars, 2)
    assert set(bn_state) == set(bn_port.module.state_dict())
    bn_port.module.load_state_dict(bn_state)
    with pytest.raises(ValueError, match="processors"):
        weathermesh_from_jax(variables, num_processors=3)


@pytest.mark.parametrize("config,steps", [
    pytest.param("small", 1, id="1"),
    pytest.param("small", 2, id="2"),
    pytest.param("wide", 1, id="wide-1"),
    pytest.param("wide", 2, id="wide-2"),
])
def test_outputs_match_jax_model(request, config, steps):
    """The port's forward against the JAX WeatherMesh (GroupNorm) on the
    same weights, at forecast_steps 1 and 2 (the processor chain twice): at
    SMALL, and at WIDE (heads of 96 at kernel (5, 7, 7), the shapes K6 takes
    on the card), weights carried by convert.weathermesh_from_jax."""
    ref, variables, port, (surface, pressure), _ = request.getfixturevalue(config)
    want = jax.jit(ref.apply, static_argnums=3)(
        variables, jnp.asarray(surface), jnp.asarray(pressure), steps
    )
    got = port(surface, pressure, forecast_steps=steps)
    assert got.surface.shape == surface.shape and got.pressure.shape == pressure.shape
    np.testing.assert_allclose(got.surface.numpy(), np.asarray(want.surface), atol=1e-4)
    np.testing.assert_allclose(got.pressure.numpy(), np.asarray(want.pressure), atol=1e-4)


@pytest.mark.parametrize("norm", ["group", "batch"])
@pytest.mark.parametrize("is_3d", [False, True])
@pytest.mark.parametrize("up", [False, True])
def test_conv_blocks_match_jax(up, is_3d, norm):
    """ConvDownBlock / ConvUpBlock alone, channels-last in JAX against
    channels-first in the port, 2D and 3D, both norms (random norm scales
    and biases; BatchNorm with random running statistics)."""
    rng = np.random.default_rng(5)
    c_in, c_out = 6, 8
    shape = (2, 3, 8, 12, c_in) if is_3d else (2, 8, 12, c_in)
    x = rng.standard_normal(shape).astype(np.float32)
    if up:
        ref = jax_model.ConvUpBlock(c_out, is_3d=is_3d, norm=norm)
        port = ConvUpBlock(c_in, c_out, is_3d=is_3d, norm=norm)
    else:
        stride = (1, 2, 2) if is_3d else 2
        ref = jax_model.ConvDownBlock(c_out, is_3d=is_3d, stride=stride, norm=norm)
        port = ConvDownBlock(c_in, c_out, is_3d=is_3d, stride=stride, norm=norm)
    def draw(path, leaf):  # numpy values for the block's variables
        name = path[-1].key
        if name == "kernel":
            bound = np.prod(leaf.shape[:-1]) ** -0.5
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)  # bias, mean

    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(2), jnp.asarray(x))
    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    want = np.asarray(jax.jit(ref.apply)(variables, jnp.asarray(x)))
    port.load_state_dict(_wm_block_state(
        variables["params"], variables.get("batch_stats"), "upsample" if up else "downsample"
    ))
    xt = torch.from_numpy(x).movedim(-1, 1)
    with torch.no_grad():
        got = port(xt).movedim(1, -1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def _objective(pred_surface, pred_pressure, tgt_surface, tgt_pressure, mean):
    """bench.py's objective: MSE on surface plus MSE on pressure."""
    return mean((pred_surface - tgt_surface) ** 2) + mean((pred_pressure - tgt_pressure) ** 2)


def _jax_loss_fn(pred, tgt):
    return _objective(pred.surface, pred.pressure, *tgt, jnp.mean)


def _port_loss_fn(pred, tgt):
    return _objective(pred.surface, pred.pressure, *tgt, torch.mean)


def _jax_forward(ref, variables):
    rest = {k: v for k, v in variables.items() if k != "params"}
    return lambda p, s, pr: ref.apply({"params": p, **rest}, s, pr, 1)


CONFIGS = {"small": SMALL, "wide": WIDE}
_JAX_GRADS = {}


def _jax_value_and_grad(request, config):
    """jax.value_and_grad of bench.py's objective at `config`'s fixture
    (loss, and the gradients in the port's names), computed once."""
    if config not in _JAX_GRADS:
        ref, variables, _, (surface, pressure), targets = request.getfixturevalue(config)
        fwd = _jax_forward(ref, variables)
        tgt = tuple(jnp.asarray(t) for t in targets)

        def objective(p):
            return _jax_loss_fn(fwd(p, jnp.asarray(surface), jnp.asarray(pressure)), tgt)

        loss, grads = jax.jit(jax.value_and_grad(objective))(variables["params"])
        _JAX_GRADS[config] = float(loss), weathermesh_from_jax(
            {"params": jax.tree_util.tree_map(np.asarray, grads)}, len(CONFIGS[config]["timesteps"]))
    return _JAX_GRADS[config]


@pytest.mark.parametrize("config", ["small", "wide"])
def test_gradients_match_jax(request, config):
    """forward_fn + bench.py's objective + backward against jax.grad of the
    same objective on the same weights: every parameter tensor, rpb
    included; at SMALL, and at WIDE (the shapes K6 and K6b take on the
    card)."""
    _, _, port, (surface, pressure), targets = request.getfixturevalue(config)
    want_loss, want = _jax_value_and_grad(request, config)
    port.module.zero_grad(set_to_none=True)
    loss = _port_loss_fn(port.forward_fn()(surface, pressure),
                         tuple(torch.from_numpy(t) for t in targets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    got = {k: p.grad for k, p in port.module.named_parameters()}
    assert set(got) == set(want)
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for name, g in got.items():
        limit = max(1e-4 * want[name].abs().max().item(), floor)
        err = (g - want[name]).abs().max().item()
        assert err <= limit, f"{name}: {err} > {limit}"


@pytest.mark.parametrize("config", ["small", "wide"])
def test_train_step_matches_jax(request, config):
    """One make_train_step step (clip + AdamW, lr 1e-4) on a fresh port
    model with the fixture's weights: its loss against the JAX package's,
    every parameter moves, and on the CPU no kernel launches. At SMALL every
    parameter after the step is within 1e-5 of the JAX package's
    make_optimizer/make_train_step step. At WIDE the step's gradient norm
    before clipping is within 1e-5 of optax.global_norm of the JAX
    gradients instead, as tests/test_torch_gencast_train.py holds GenCast's
    step: the global norm is ~262, so clipping puts gradient elements that
    are ~1e-6 of a tensor's max|g| near Adam's eps, and the first step's
    g / (|g| + eps) turns their f32 rounding (both packages agree within
    1e-6 of max|g| there, test_gradients_match_jax[wide]) into parameter
    differences of up to ~3.5e-5; the optimizer itself is held to optax on
    the same gradients by test_torch_gencast_train.py."""
    ref, variables, _, (surface, pressure), targets = request.getfixturevalue(config)
    cfg = CONFIGS[config]
    n_proc = len(cfg["timesteps"])
    port = WeatherMesh(**cfg, device="cpu")
    port.module.load_state_dict(weathermesh_from_jax(variables, num_processors=n_proc))
    before = {k: v.clone() for k, v in port.module.state_dict().items()}

    def counts():
        return (natten_flash.LAUNCHES, natten_flash.BWD_DQ_LAUNCHES, natten_flash.BWD_DKV_LAUNCHES,
                natten3d.LAUNCHES, natten3d.BWD_DQ_LAUNCHES, natten3d.BWD_DKV_LAUNCHES)

    before_counts = counts()
    port_step = make_train_step(port.module.parameters(), port.forward_fn(), _port_loss_fn,
                                make_optimizer(1e-4), return_grad_norm=True)
    loss, norm = port_step(torch.from_numpy(surface), torch.from_numpy(pressure),
                           tuple(torch.from_numpy(t) for t in targets))
    after = port.module.state_dict()
    assert all(not torch.equal(after[name], before[name]) for name in after)
    assert counts() == before_counts
    if config == "wide":
        want_loss, want_grads = _jax_value_and_grad(request, config)
        np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
        want_norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in want_grads.values()))
        np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-5)
        return
    optimizer = jax_make_optimizer(1e-4)
    params = variables["params"]
    step = jax.jit(jax_make_train_step(_jax_forward(ref, variables), _jax_loss_fn, optimizer))
    new_params, _, want_loss = step(params, optimizer.init(params), jnp.asarray(surface),
                                    jnp.asarray(pressure), tuple(jnp.asarray(t) for t in targets))
    want = weathermesh_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, new_params)}, num_processors=n_proc
    )
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name, value in after.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)


def test_config_round_trip_and_errors():
    cfg = WeatherMeshConfig(**SMALL)
    assert WeatherMeshConfig.from_json(cfg.to_json()) == cfg
    model = cfg.build(device="cpu")
    assert model.device.type == "cpu"
    parts = (
        WeatherMeshEncoderConfig(3, 2, 16, 3, num_conv_blocks=2, hidden_dim=4, kernel_size=(3, 3, 3),
                                 num_heads=2, num_transformer_layers=1),
        WeatherMeshProcessorConfig(16, n_layers=1, kernel=(3, 3, 3), num_heads=2),
        WeatherMeshDecoderConfig(16, 3, 2, n_conv_blocks=2, hidden_dim=4, kernel_size=(3, 3, 3),
                                 num_heads=2, num_transformer_layers=1),
    )
    for part, module in zip(parts, (model.module.encoder, model.module.processors[0],
                                    model.module.decoder)):
        assert type(part).from_json(part.to_json()) == part
        built = part.build()
        assert {k: v.shape for k, v in built.state_dict().items()} == {
            k: v.shape for k, v in module.state_dict().items()
        }
    assert inspect.signature(WeatherMesh).parameters["device"].default == "cuda"
    surface, pressure = _batch(np.random.default_rng(6))
    with pytest.raises(ValueError, match="expected surface"):
        model(surface, pressure[:, :2])
    with pytest.raises(ValueError, match="unknown norm"):
        WeatherMesh(**SMALL, norm="layer", device="cpu")


def test_init_draws_the_jax_initializers_from_a_seed():
    """init(generator): the same seed gives the same weights; conv biases,
    rpb and norm biases 0, norm scales 1 (the JAX package's initializers);
    conv kernels within lecun-normal's 2-sigma truncation."""
    a, b = (WeatherMesh(**SMALL, device="cpu") for _ in range(2))
    sa, sb = (m.init(torch.Generator().manual_seed(3)) for m in (a, b))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for name, t in sa.items():
        if name.endswith("rpb") or (name.endswith(".bias") and ("to_latent" in name or "split" in name)):
            assert bool((t == 0).all()), name
    assert bool((sa["encoder.surface_path.0.bn1.weight"] == 1).all())
    w = sa["encoder.pressure_path.0.conv1.weight"]
    limit = 2 * w[0].numel() ** -0.5 / 0.87962566103423978
    assert w.abs().max().item() <= limit and w.std().item() > 0.5 * w[0].numel() ** -0.5


@pytest.mark.parametrize("ndim", [2, 3])
def test_cpu_convs_run_without_onednn(monkeypatch, ndim):
    """On CPU tensors the model's convs run with oneDNN off in the forward and
    in the backward (whose kernel reads the global flag when it runs), and
    give nn.Conv's outputs and gradients."""
    seen, before, without = [], torch.backends.mkldnn.enabled, wm_model._without_onednn

    @contextlib.contextmanager
    def spy():
        with without():
            seen.append(torch.backends.mkldnn.enabled)
            yield

    monkeypatch.setattr(wm_model, "_without_onednn", spy)
    conv = wm_model._conv(ndim, 3, 5, 3, stride=2, padding=1)
    plain = (torch.nn.Conv3d if ndim == 3 else torch.nn.Conv2d)(3, 5, 3, stride=2, padding=1)
    plain.load_state_dict(conv.state_dict())
    x = torch.randn(2, 3, *(6,) * ndim, generator=torch.Generator().manual_seed(0))
    x_conv, x_plain = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = conv(x_conv)
    torch.testing.assert_close(out, plain(x_plain), atol=1e-6, rtol=0)
    grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    out.backward(grad)
    plain(x_plain).backward(grad)
    assert seen == [False, False] and torch.backends.mkldnn.enabled == before
    for a, b in ((x_conv, x_plain), (conv.weight, plain.weight), (conv.bias, plain.bias)):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=0)
