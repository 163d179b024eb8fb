"""WeatherMesh's bf16 compute policy against the JAX package's, on the CPU:
WeatherMesh.forward_fn(compute_dtype=bfloat16) against the JAX module under
bench.py's `_wm_bf16` (every floating variable and both inputs cast to bf16,
the loss on the bf16 outputs upcast to f32, gradients to the f32 parameters),
each JAX forward and backward in one jit, as bench.py's train step runs.

The rule: RMSE(port bf16 - JAX bf16) <= r x RMSE(JAX bf16 - JAX f32), the
JAX package's f32 run on the same inputs being the yardstick of how far
bf16 moves a result.

  * The conv blocks (2D and 3D, down and up) and an attention layer (heads
    of 96 at (5, 7, 7): the slot path), forward and backward, at r = 0.2.
    The blocks read 0 (bit for bit) but the 3D up block's input gradient,
    ~0.13: XLA's and PyTorch's 3D convolutions sum in different orders, and
    a GroupNorm reads its conv's f32 result; the attention layer ~0.1.
  * The whole model at GROUPED (WIDE's attention, the slot path, with
    WEATHERMESH's conv widths: several channels a GroupNorm group), each
    unit (conv block, attention layer, 1x1x1 conv) fed the JAX bf16 run's
    input and handed its output cotangent, in both packages: every unit's
    output, every cotangent the units return, the loss and every
    parameter gradient at r = 0.5, the GroupNorms' scale and bias
    gradients in one global norm (one by one they read up to 0.45 here and
    0.74 under other draws of the weights: f32
    sums of the wide convs in another order flip a bf16 rounding in a few
    in 10^4, which the block's second conv spreads, and such a gradient
    sums one channel over every position). Here the yardstick is the JAX
    f32 run forced the same way, so that it holds each unit's own
    roundings; the control, the port run in f32, reads ~1.0 on each and
    must miss the rule. The units are forced because WeatherMesh in bf16
    is chaotic: one flipped rounding spreads through each conv and
    attention layer, and the port's free-run outputs move 0.81 of their
    bf16-to-f32 distance when only its convolutions' f32 summation order
    changes (test_bf16_free_run_moves_with_conv_order). One rounding point
    is not mirrored: XLA computes bench.py's objective from the model's last
    GELU product unrounded (its only use on that path is the f32 upcast),
    where the port's forward_fn returns the bf16 outputs; the port's loss
    reads 0.58 against the JAX program's own and 0.04 against the
    objective of the JAX run's bf16 outputs, which the test holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from graph_weather_tpu.models.weathermesh import WeatherMesh as JaxWeatherMesh
from graph_weather_tpu.models.weathermesh import model as jax_model
from graph_weather_tpu.nn.mlp import TorchLinear
from graph_weather_tpu_torch import WeatherMesh, make_optimizer, make_train_step, weathermesh_from_jax
from graph_weather_tpu_torch.convert import _wm_block_state
from graph_weather_tpu_torch.models.weathermesh import ConvDownBlock, ConvUpBlock, NeighborhoodAttention3D
from graph_weather_tpu_torch.models.weathermesh import model as wm_model
from graph_weather_tpu_torch.models.weathermesh.model import POLICY_TODO, _conv_weights
from graph_weather_tpu_torch.nn.bf16 import Bf16Params, bias_add
from graph_weather_tpu_torch.ops.neighborhood_attention import _cpu_path, route

torch.set_num_threads(1)
BF16 = torch.bfloat16
RULE = 0.5
WIDE = dict(
    timesteps=[0], surface_channels=3, pressure_channels=2, pressure_levels=4,
    latent_dim=192, encoder_num_conv_blocks=2, encoder_num_transformer_layers=1,
    encoder_hidden_dim=4, decoder_num_conv_blocks=2, decoder_num_transformer_layers=1,
    decoder_hidden_dim=4, processor_num_layers=1, kernel=(5, 7, 7), num_heads=2,
)
NARROW = dict(WIDE, latent_dim=128, num_heads=4, kernel=(3, 5, 5))  # 4 x 32: the flash path
# WIDE's attention with WEATHERMESH's conv widths: GroupNorms of 4 and 8
# channels a group in the encoder and of 4 and 2 in the decoder.
GROUPED = dict(WIDE, encoder_hidden_dim=64, decoder_hidden_dim=64)
GRID = (28, 28)


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def _global_norm(grads):
    return float(np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2)) for g in grads.values())))


def _batch(rng, cfg):
    h, w = GRID
    return (rng.standard_normal((1, h, w, cfg["surface_channels"])).astype(np.float32),
            rng.standard_normal((1, cfg["pressure_levels"], h, w,
                                 cfg["pressure_channels"])).astype(np.float32))


def _wm_bf16(tree):
    """bench.py's cast: every floating leaf to bf16."""
    return jax.tree_util.tree_map(
        lambda t: t.astype(jnp.bfloat16) if jnp.issubdtype(t.dtype, jnp.floating) else t, tree)


def _objective(pred_surface, pred_pressure, tgt, mean):
    return mean((pred_surface - tgt[0]) ** 2) + mean((pred_pressure - tgt[1]) ** 2)


def _jax_vjp(module, variables, x, g):
    """{"f32", "bf16"}: (out, dx, parameter gradients) of the flax `module`
    in f32 and under _wm_bf16, its forward and vjp in one jit, as numpy f32."""
    runs = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        @jax.jit
        def vjp(v, xx, gg, dt=dt):
            out, back = jax.vjp(
                lambda v_, x_: module.apply(v_ if dt == jnp.float32 else _wm_bf16(v_), x_), v, xx)
            gv, gx = back(gg.astype(dt))
            return out, gx, gv

        out, gx, gv = vjp(variables, jnp.asarray(x).astype(dt), jnp.asarray(g))
        runs[name] = (np.asarray(out.astype(jnp.float32)), np.asarray(gx.astype(jnp.float32)),
                      jax.tree_util.tree_map(lambda t: np.asarray(t, np.float32), gv["params"]))
    return runs


def _port_vjp(module, x, g):
    """(out, dx, parameter gradients) of the port's `module` under the bf16
    policy (WeatherMesh's: Bf16Params with the convs' weights kept f32)."""
    params = Bf16Params(module, keep_f32=_conv_weights(module))()
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    out = torch.func.functional_call(module, params, (xt,))
    leaves = [xt] + list(module.parameters())
    dx, *grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).bfloat16())
    return (out.detach().float().numpy(), dx.float().numpy(),
            {n: gr.numpy() for (n, _), gr in zip(module.named_parameters(), grads)})


def _layer_readings(got, runs, state):
    """Readings of out, dx and the parameter gradients (global norm, in the
    port's names through `state`)."""
    (out16, dx16, gv16), (out32, dx32, gv32) = runs["bf16"], runs["f32"]
    want, base = (state(gv) for gv in (gv16, gv32))
    assert got[2].keys() == want.keys()
    return {
        "out": _rmse(got[0], out16) / _rmse(out16, out32),
        "dx": _rmse(got[1], dx16) / _rmse(dx16, dx32),
        "params": _global_norm({k: got[2][k] - want[k] for k in want})
        / _global_norm({k: want[k] - base[k] for k in want}),
    }


@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("is_3d", [False, True], ids=["2d", "3d"])
def test_bf16_conv_blocks_match_jax(up, is_3d):
    """ConvDownBlock and ConvUpBlock (GroupNorm) under the bf16 policy against
    the JAX blocks under _wm_bf16: out, the input's gradient and the
    parameters' gradients within rule 0.2 (random norm scales and biases)."""
    rng = np.random.default_rng(5)
    c_in, c_out = 6, 8
    x = rng.standard_normal((2, 3, 8, 12, c_in) if is_3d else (2, 8, 12, c_in)).astype(np.float32)
    if up:
        ref, port = jax_model.ConvUpBlock(c_out, is_3d=is_3d), ConvUpBlock(c_in, c_out, is_3d=is_3d)
    else:
        stride = (1, 2, 2) if is_3d else 2
        ref = jax_model.ConvDownBlock(c_out, is_3d=is_3d, stride=stride)
        port = ConvDownBlock(c_in, c_out, is_3d=is_3d, stride=stride)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            bound = np.prod(leaf.shape[:-1]) ** -0.5
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(ref.init, jax.random.PRNGKey(2), jnp.asarray(x)))
    g = rng.standard_normal(jax.eval_shape(ref.apply, variables, jnp.asarray(x)).shape).astype(np.float32)
    kind = "upsample" if up else "downsample"

    def state(params):
        return {k: v.numpy() for k, v in _wm_block_state(params, None, kind).items()}

    port.load_state_dict(_wm_block_state(variables["params"], None, kind))
    got = _port_vjp(port, np.moveaxis(x, -1, 1).copy(), np.moveaxis(g, -1, 1).copy())
    got = (np.moveaxis(got[0], 1, -1), np.moveaxis(got[1], 1, -1), got[2])
    readings = _layer_readings(got, _jax_vjp(ref, variables, x, g), state)
    assert all(r <= 0.2 for r in readings.values()), readings


def test_bf16_attention_layer_matches_jax():
    """An attention layer (qkv, the 3D neighborhood attention, proj) under
    the bf16 policy against the JAX layer under _wm_bf16, heads of 96 at
    (5, 7, 7) (the slot path; the JAX package's XLA scan): out, the input's
    gradient and the parameters' gradients within rule 0.2."""
    rng = np.random.default_rng(3)
    heads, c, kernel = 2, 192, (5, 7, 7)
    x = rng.standard_normal((1, 5, 7, 9, c)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    ref = jax_model.NeighborhoodAttention3D(embed_dim=c, num_heads=heads, kernel_size=kernel)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            bound = leaf.shape[0] ** -0.5
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if name == "rpb":
            return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(ref.init, jax.random.PRNGKey(0), jnp.asarray(x)))

    def state(p):
        return {"qkv.weight": p["TorchLinear_0"]["kernel"].T, "qkv.bias": p["TorchLinear_0"]["bias"],
                "rpb": p["rpb"], "proj.weight": p["TorchLinear_1"]["kernel"].T,
                "proj.bias": p["TorchLinear_1"]["bias"]}

    port = NeighborhoodAttention3D(c, heads, kernel)
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in state(variables["params"]).items()})
    readings = _layer_readings(_port_vjp(port, x, g), _jax_vjp(ref, variables, x, g), state)
    assert all(r <= 0.2 for r in readings.values()), readings


@pytest.mark.parametrize("dims,axis", [
    ((1, 5, 7, 9), -1),  # the tests' latent: one serial sum
    ((2, 33, 3, 70), -1),  # windows of 17 + 16 and of 19 + 32 + 19 rows
    ((1, 14, 45, 90), -1),  # the 1 degree latent (qkv, proj)
    ((1, 14, 45, 90), 1),  # the same through a 1x1x1 conv's channels-first layout
], ids=["serial", "odd", "latent_1deg", "conv_layout"])
def test_bias_add_grad_matches_xla(dims, axis):
    """nn.bf16.bias_add's bias gradient equals, bit for bit, the JAX
    package's bf16 bias gradient (the transpose of the broadcast add, one
    jit) on the same cotangent: XLA:CPU's windowed sum (xla_sum_order),
    at the 1 degree latent too, whose H and W (45, 90) exceed a window."""
    rng = np.random.default_rng(7)
    width = 8
    cot = jnp.asarray(rng.standard_normal(dims + (width,)), jnp.bfloat16)
    y = jnp.zeros(cot.shape, jnp.bfloat16)
    want = jax.jit(lambda c: jax.vjp(lambda b: y + b, jnp.zeros(width, jnp.bfloat16))[1](c)[0])(cot)
    grad = torch.from_numpy(np.array(cot.astype(jnp.float32))).bfloat16()
    if axis != -1:
        grad = grad.movedim(-1, axis).contiguous()
    bias = torch.zeros(width, dtype=BF16, requires_grad=True)
    bias_add(torch.zeros_like(grad), bias, axis).backward(grad)
    assert torch.equal(bias.grad.float(), torch.from_numpy(np.asarray(want.astype(jnp.float32))))


class _Projection(torch.nn.Module):
    """One linear as the attention layers run theirs (`_linear`)."""

    def __init__(self, width):
        super().__init__()
        self.linear = torch.nn.Linear(width, width)

    def forward(self, x):
        return wm_model._linear(self.linear, x)


def test_bf16_linear_bias_grad_matches_jax_at_1deg():
    """An attention projection (TorchLinear, 16 -> 16) over the 1 degree
    latent's rows under _wm_bf16, its forward and vjp in one jit as in the
    model's train step: the port's projection under the bf16 policy gets
    the bias gradient bit for bit."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 14, 45, 90, 16)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    ref = TorchLinear(16)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))

    @jax.jit
    def bias_grad(v, xx, gg):
        _, back = jax.vjp(lambda v_: ref.apply(_wm_bf16(v_), xx.astype(jnp.bfloat16)), v)
        return back(gg.astype(jnp.bfloat16))[0]["params"]["bias"]

    want = np.asarray(bias_grad(variables, jnp.asarray(x), jnp.asarray(g)))
    port = _Projection(16)
    kernel, bias = (np.asarray(variables["params"][k]) for k in ("kernel", "bias"))
    port.load_state_dict({"linear.weight": torch.from_numpy(kernel.T.copy()),
                          "linear.bias": torch.from_numpy(bias)})
    got = _port_vjp(port, x, g)[2]["linear.bias"]
    assert np.array_equal(got, want)


def _is_unit(context) -> bool:
    """Whether a flax call is one of the JAX module's units: a conv block,
    an attention layer, or the encoder's and decoder's 1x1x1 convs."""
    module = context.module
    if context.method_name != "__call__":
        return False
    if isinstance(module, (jax_model.ConvDownBlock, jax_model.ConvUpBlock,
                           jax_model.NeighborhoodAttention3D)):
        return True
    return type(module) is flax_nn.Conv and isinstance(
        module.parent, (jax_model.WeatherMeshEncoder, jax_model.WeatherMeshDecoder))


@jax.custom_vjp
def _substitute(x, value):
    """`value` in place of x, the gradient passed on to x."""
    return value


_substitute.defvjp(lambda x, value: (value, None), lambda _, g: (g, None))


@jax.custom_vjp
def _force(out, cotangent):
    """out, whose gradient is `cotangent` whatever reaches it."""
    return out


_force.defvjp(lambda out, cotangent: (out, cotangent),
              lambda cotangent, _: (cotangent, jnp.zeros_like(cotangent)))


def _jax_forced_runs(ref, variables, surface, pressure, targets):
    """The JAX module's run under _wm_bf16, and its f32 run forced onto it.

    bf16: the gradients of bench.py's objective, and each unit's input,
    output and output cotangent (a zero added to each output, whose
    gradient is that cotangent). f32: each unit fed the bf16 run's input
    (`_substitute`) and handed its output cotangent (`_force`), so that
    each unit's result, the cotangent its downstream units return, and
    each parameter gradient differ from the bf16 run's only by that unit's
    own bf16 roundings. Both as numpy f32 (gradients in the port's names)."""
    s16, p16 = (jnp.asarray(t).astype(jnp.bfloat16) for t in (surface, pressure))
    shapes = []

    def shape_of(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if _is_unit(context):
            shapes.append(out.shape)
        return out

    with flax_nn.intercept_methods(shape_of):
        jax.eval_shape(lambda v: ref.apply(_wm_bf16(v), s16, p16, 1), variables)

    def run(params, zeros, units, apply):
        def loss(params_, zeros_):
            seen = []

            def intercept(next_fun, args, kwargs, context):
                if not _is_unit(context):
                    return next_fun(*args, **kwargs)
                return units(len(seen), next_fun, args, kwargs, zeros_, seen)

            with flax_nn.intercept_methods(intercept):
                out = apply(params_)
            return _objective(out.surface.astype(jnp.float32), out.pressure.astype(jnp.float32),
                              targets, jnp.mean), seen
        return jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, zeros)

    def record(i, next_fun, args, kwargs, zeros, seen):
        out = next_fun(*args, **kwargs) + zeros[i]
        seen.append((args[0], out))
        return out

    @jax.jit
    def bf16(params):
        zeros = [jnp.zeros(shape, jnp.bfloat16) for shape in shapes]
        return run(params, zeros, record, lambda v: ref.apply(_wm_bf16({"params": v}), s16, p16, 1))

    (_, seen16), (grads16, cots16) = bf16(variables["params"])
    ins16 = [x for x, _ in seen16]

    def forced(i, next_fun, args, kwargs, zeros, seen):
        out = next_fun(_substitute(args[0], ins16[i].astype(jnp.float32)), *args[1:], **kwargs)
        seen.append(out)
        return _force(out, cots16[i].astype(jnp.float32)) + zeros[i]

    @jax.jit
    def f32(params):
        zeros = [jnp.zeros(shape, jnp.float32) for shape in shapes]
        return run(params, zeros, forced, lambda v: ref.apply({"params": v}, s16.astype(jnp.float32),
                                                              p16.astype(jnp.float32), 1))

    (_, outs32), (grads32, cots32) = f32(variables["params"])

    def arrays(ts):
        return [np.asarray(jnp.asarray(t).astype(jnp.float32)) for t in ts]

    def port_names(grads):
        return {k: v.numpy() for k, v in weathermesh_from_jax(
            {"params": jax.tree_util.tree_map(np.asarray, grads)}, 1).items()}

    return (dict(ins=arrays(ins16), outs=arrays(out for _, out in seen16),
                 cots=arrays(cots16), grads=port_names(grads16)),
            dict(outs=arrays(outs32), cots=arrays(cots32), grads=port_names(grads32)))


class _Substitute(torch.autograd.Function):
    """`value` in place of x, the gradient passed on to x."""

    @staticmethod
    def forward(ctx, x, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Force(torch.autograd.Function):
    """out, whose gradient is `cotangent`; the gradient that reaches it is
    appended to `seen`."""

    @staticmethod
    def forward(ctx, out, cotangent, seen):
        ctx.cotangent, ctx.seen = cotangent, seen
        return out.clone()

    @staticmethod
    def backward(ctx, grad):
        ctx.seen.append(grad.float().numpy().copy())
        return ctx.cotangent, None, None


def _port_units(module):
    """The port's units in the JAX module's call order."""
    enc, dec = module.encoder, module.decoder
    units = [b for pair in zip(enc.surface_path, enc.pressure_path) for b in pair]
    units += [enc.to_latent, *enc.transformer_layers,
              *(layer for p in module.processors for layer in p.layers),
              *dec.transformer_layers, dec.split]
    return units + [b for pair in zip(dec.pressure_path, dec.surface_path) for b in pair]


def _port_forced(port, jax_bf16, surface, pressure, targets, dtype):
    """forward_fn(compute_dtype=dtype) and bench.py's objective with every
    unit fed the JAX bf16 run's input and handed its output cotangent, as
    `_jax_forced_runs`' f32 run: the loss, each unit's output and the
    cotangent its downstream units return (channels-last), and the
    parameter gradients."""
    units = _port_units(port.module)
    assert len(units) == len(jax_bf16["ins"])

    def layout(t, unit):  # the JAX module's channels-last to the unit's layout
        t = t if isinstance(unit, NeighborhoodAttention3D) else np.moveaxis(t, -1, 1)
        return torch.from_numpy(np.ascontiguousarray(t)).to(dtype)

    def channels_last(t, unit):
        return t if isinstance(unit, NeighborhoodAttention3D) else np.moveaxis(t, 1, -1)

    outs, seen, hooks = [None] * len(units), [[] for _ in units], []

    def feed(i):
        return lambda unit, args: (_Substitute.apply(args[0], layout(jax_bf16["ins"][i], unit)),)

    def hand(i):
        def hook(unit, args, out):
            outs[i] = channels_last(out.detach().float().numpy(), unit)
            return _Force.apply(out, layout(jax_bf16["cots"][i], unit), seen[i])
        return hook

    for i, unit in enumerate(units):
        hooks += [unit.register_forward_pre_hook(feed(i)), unit.register_forward_hook(hand(i))]
    try:
        port.module.zero_grad(set_to_none=True)
        out = port.forward_fn(compute_dtype=dtype)(surface, pressure)
        loss = _objective(out.surface.float(), out.pressure.float(),
                          tuple(torch.from_numpy(t) for t in targets), torch.mean)
        loss.backward()
    finally:
        for hook in hooks:
            hook.remove()
    return dict(loss=loss.item(), outs=outs,
                cots=[channels_last(s[0], unit) for s, unit in zip(seen, units)],
                grads={k: p.grad.numpy().copy() for k, p in port.module.named_parameters()})


def _forced_readings(got, jax_bf16, jax_f32, names, targets):
    """(readings, exact): each quantity's RMSE to the JAX bf16 run over the
    forced JAX f32 run's (the GroupNorms' scale and bias gradients in one
    global norm; the loss as bench.py's objective of each run's outputs,
    see the module docstring); and for the gradients that both JAX runs get bit for bit
    (the 1x1x1 convs' weights, whose gradients XLA keeps in f32), the RMSE
    to the JAX bf16 run over the gradient's RMS."""
    loss16, loss32 = (_objective(outs[-1], outs[-2], targets, np.mean)
                      for outs in (jax_bf16["outs"], jax_f32["outs"]))
    readings = {"loss": abs(got["loss"] - loss16) / abs(loss32 - loss16)}
    for i, name in enumerate(names):
        for kind in ("outs", "cots"):
            readings[f"{kind} {name}"] = (_rmse(got[kind][i], jax_bf16[kind][i])
                                          / _rmse(jax_f32[kind][i], jax_bf16[kind][i]))
    norms = [k for k in jax_bf16["grads"] if ".bn" in k]
    readings["grads (GroupNorms)"] = (
        _global_norm({k: got["grads"][k] - jax_bf16["grads"][k] for k in norms})
        / _global_norm({k: jax_f32["grads"][k] - jax_bf16["grads"][k] for k in norms}))
    exact = {}
    for k, want in jax_bf16["grads"].items():
        if k not in norms:
            base = _rmse(jax_f32["grads"][k], want)
            (readings if base else exact)[k] = _rmse(got["grads"][k], want) / (base or _rmse(want, 0))
    return readings, exact


@pytest.fixture(scope="module")
def grouped():
    """The JAX WeatherMesh at GROUPED with numpy weights (kernels uniform in
    +-1/sqrt(fan_in), rpb ~N(0, 0.3^2), norm scales 1, biases 0), a batch and
    targets, `_jax_forced_runs`, and the port with the same weights and its
    units' names."""
    ref = JaxWeatherMesh(**GROUPED)
    rng = np.random.default_rng(0)
    surface, pressure = _batch(rng, GROUPED)
    shapes = jax.eval_shape(
        lambda key: ref.init(key, jnp.asarray(surface), jnp.asarray(pressure), 1), jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            bound = np.prod(leaf.shape[:-1]) ** -0.5
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if name == "rpb":
            return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (np.ones if name == "scale" else np.zeros)(leaf.shape, np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    targets = _batch(rng, GROUPED)
    port = WeatherMesh(**GROUPED, device="cpu")
    port.module.load_state_dict(weathermesh_from_jax(variables, 1))
    names = {id(m): n for n, m in port.module.named_modules()}
    names = [names[id(unit)] for unit in _port_units(port.module)]
    runs = _jax_forced_runs(ref, variables, surface, pressure, targets)
    return port, (surface, pressure), targets, runs, names


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32_control"])
def test_bf16_matches_jax_module(grouped, dtype):
    """forward_fn(compute_dtype=bfloat16) and bench.py's objective against
    the JAX module under _wm_bf16 at GROUPED, each unit fed the JAX bf16
    run's input and handed its output cotangent (`_jax_forced_runs`): the
    loss, every unit's output, every cotangent its downstream units
    return, every parameter gradient, and the GroupNorms' gradients in
    global norm, within rule 0.5 (the module docstring). The control, the
    port run in f32 with the same forcing, must miss the rule on every one
    of them. The 1x1x1 convs' weight gradients, which the bf16 policy keeps
    in f32, are held to both JAX runs' within f32 summation order."""
    port, (surface, pressure), targets, (jax_bf16, jax_f32), names = grouped
    got = _port_forced(port, jax_bf16, surface, pressure, targets, dtype)
    assert got["grads"].keys() == jax_bf16["grads"].keys()
    readings, exact = _forced_readings(got, jax_bf16, jax_f32, names, targets)
    assert exact.keys() == {"encoder.to_latent.weight", "decoder.split.weight"}
    assert all(r <= 1e-5 for r in exact.values()), exact  # f32 sums in another order
    if dtype == BF16:
        assert all(r <= RULE for r in readings.values()), {k: r for k, r in readings.items() if r > RULE}
    else:
        assert all(r > RULE for r in readings.values()), {k: r for k, r in readings.items() if r <= RULE}


def _conv_order_changed(fn):
    """fn() with the port's normed convolutions summed in float64 and
    rounded to f32: the same products, summed in another order."""
    forward = wm_model._Bf16Conv.forward

    def f64(ctx, x, weight, stride, padding, rounded):
        forward(ctx, x, weight, stride, padding, rounded)  # saves what the backward reads
        y = torch.ops.aten.convolution(x.double(), weight.to(BF16).double(), None, *ctx.conf[:3],
                                       False, ctx.conf[3], 1).float()
        return y.to(BF16) if rounded else y

    wm_model._Bf16Conv.forward = staticmethod(f64)
    try:
        return fn()
    finally:
        wm_model._Bf16Conv.forward = staticmethod(forward)


def test_bf16_free_run_moves_with_conv_order(grouped):
    """Why test_bf16_matches_jax_module forces the units: run freely, the
    bf16 model at GROUPED is chaotic. Summing only its convolutions in
    another order moves its outputs by more than the rule's 0.5 of its own
    bf16-to-f32 distance, so no port that sums in another order than XLA's
    could be held to the JAX module's free run at 0.5."""
    port, (surface, pressure), *_ = grouped

    def outputs(dtype):
        with torch.no_grad():
            out = port.forward_fn(compute_dtype=dtype)(surface, pressure)
        return np.concatenate([t.float().numpy().ravel() for t in (out.surface, out.pressure)])

    bf16, f32 = outputs(BF16), outputs(torch.float32)
    assert _rmse(_conv_order_changed(lambda: outputs(BF16)), bf16) > RULE * _rmse(bf16, f32)


def test_bf16_train_step_keeps_f32_parameters():
    """make_train_step over the bf16 forward_fn (bench.py's weathermesh_train
    objective, make_optimizer(1e-4)): the parameters, their gradients and the
    optimizer's moments stay f32, and every parameter moves."""
    port = WeatherMesh(**WIDE, device="cpu")
    port.init(torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in port.module.parameters()]
    rng = np.random.default_rng(1)
    surface, pressure = _batch(rng, WIDE)
    targets = tuple(torch.from_numpy(t) for t in _batch(rng, WIDE))
    step = make_train_step(
        port.module.parameters(), port.forward_fn(compute_dtype=BF16),
        lambda pred, tgt: _objective(pred.surface.float(), pred.pressure.float(), tgt, torch.mean),
        make_optimizer(1e-4),
    )
    loss = step(surface, pressure, targets)
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    params = list(port.module.parameters())
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in params)
    moments = [t for s in step.optimizer.state.values() for t in s.values()
               if isinstance(t, torch.Tensor) and t.is_floating_point()]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    assert all(not torch.equal(a, b) for a, b in zip(before, params))


def test_bf16_request_holds_bf16_outputs():
    """apply(..., compute_dtype=bfloat16) serves in bf16: bf16 outputs of the
    f32 path's shapes, bit-equal to forward_fn(bfloat16) under no_grad, and
    one bf16 copy of the parameters kept while they are unchanged; the
    module's parameters stay f32."""
    port = WeatherMesh(**WIDE, device="cpu")
    port.init(torch.Generator().manual_seed(2))
    surface, pressure = _batch(np.random.default_rng(3), WIDE)
    out = port.apply(surface, pressure, compute_dtype=BF16)
    copy = port._bf16._copy
    with torch.no_grad():
        again = port.forward_fn(compute_dtype=BF16)(surface, pressure)
    assert port._bf16._copy is copy
    assert out.surface.dtype == BF16 and out.pressure.dtype == BF16
    assert out.surface.shape == surface.shape and out.pressure.shape == pressure.shape
    assert torch.equal(out.surface, again.surface) and torch.equal(out.pressure, again.pressure)
    assert bool(torch.isfinite(out.surface.float()).all() and torch.isfinite(out.pressure.float()).all())
    assert {p.dtype for p in port.module.parameters()} == {torch.float32}
    f32 = port(surface, pressure)
    assert f32.surface.dtype == torch.float32


def test_other_compute_dtypes_raise():
    """float16 raises and names the ROADMAP item, and so does bf16 with the
    inference BatchNorm (norm="batch"), which has no bf16 policy."""
    port = WeatherMesh(**WIDE, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as info:
        port.forward_fn(compute_dtype=torch.float16)
    assert POLICY_TODO in str(info.value)
    with pytest.raises(NotImplementedError, match="norm='batch'"):
        WeatherMesh(**WIDE, norm="batch", device="cpu").forward_fn(compute_dtype=BF16)
    assert port.forward_fn(compute_dtype=torch.float32) is not None


@pytest.mark.parametrize("cfg,path", [(WIDE, "slot"), (NARROW, "flash")], ids=["wide", "narrow"])
def test_bf16_attention_takes_routes_path(monkeypatch, cfg, path):
    """Every attention layer of a bf16 request gets bf16 q, k, v and rpb, and
    the CPU runs the plain version of what `route` names for the card:
    the slot scan's roundings at WIDE, K5a/K5b's at 4 x 32 heads."""
    seen = []

    def spy(q, k, v, kernel, rpb, circular_w, *args, **kwargs):
        seen.append((q.dtype, k.dtype, v.dtype, rpb.dtype,
                     _cpu_path(tuple(q.shape), kernel, circular_w, True, False, "auto"),
                     route(tuple(q.shape), kernel, circular_w, True, False)))
        return attention(q, k, v, kernel, rpb, circular_w, *args, **kwargs)

    attention = wm_model.neighborhood_attention_3d
    monkeypatch.setattr(wm_model, "neighborhood_attention_3d", spy)
    port = WeatherMesh(**cfg, device="cpu")
    port.init(torch.Generator().manual_seed(4))
    port.apply(*_batch(np.random.default_rng(5), cfg), compute_dtype=BF16)
    assert len(seen) == 3 and set(seen) == {(BF16,) * 4 + (path, path)}
