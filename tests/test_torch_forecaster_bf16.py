"""The port's bf16 forecaster against the JAX package's bf16 policy, on the CPU.

GraphWeatherForecaster.forward_fn(compute_dtype=bfloat16) in both packages,
at the 30° grid and the small widths of tests/test_torch_forecaster.py's
CONFIG, with the same weights (flax init -> convert.from_jax_params) and
numpy inputs. The port runs its plain versions here: the edge updates'
bf16 chain and backward (ops/fused_mlp.py) and the bf16 segment sum's
(ops/scatter.py). Rules:
  * the sums, bit for bit: the plain version of the edge-order segment sum
    against jax.ops.segment_sum in bf16 and against the bf16 gradient of
    jnp.take (the scatter-add XLA makes of it), its own gradient, GenCast's
    bf16 segment softmax through it, and the bf16 padded-table sum against
    the JAX package's padded_csr_agg;
  * an EdgeBlock, a NodeBlock and the whole forward: RMSE(port bf16 - JAX
    bf16) <= 0.5 RMSE(JAX bf16 - JAX f32), the same rule as GenCast's bf16
    tests; the loss and the parameters' gradients by the same rule, the
    gradients in global norm;
  * use_checkpointing: bit-equal bf16 gradients; a bf16 train step keeps
    f32 parameters and optimizer state; a bf16 rollout is finite; other
    dtypes raise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.models import forecast as jax_forecast
from graph_weather_tpu.models.losses import NormalizedMSELoss as JaxLoss
from graph_weather_tpu.nn import graph_blocks as jax_blocks
from graph_weather_tpu.ops import scatter as jax_scatter
from graph_weather_tpu.ops.segment_softmax import segment_softmax as jax_segment_softmax
from graph_weather_tpu_torch import (
    GraphWeatherForecaster,
    NormalizedMSELoss,
    from_jax_params,
    make_optimizer,
    make_train_step,
)
from graph_weather_tpu_torch.models.forecast import TF32_TODO
from graph_weather_tpu_torch.nn.bf16 import Bf16Params
from graph_weather_tpu_torch.nn.graph_blocks import EdgeBlock, NodeBlock
from graph_weather_tpu_torch.ops import fused_mlp, scatter
from graph_weather_tpu_torch.ops.segment_softmax import segment_softmax
from graph_weather_tpu_torch.train.rollout import make_rollout_fn
from test_torch_forecaster import CONFIG, WIDTH, _grid

torch.set_num_threads(1)
FEATURES, AUX = CONFIG["feature_dim"], CONFIG["aux_dim"]
RULE = 0.5  # RMSE(port bf16 - JAX bf16) over RMSE(JAX bf16 - JAX f32)
BF16 = jnp.bfloat16


def _rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def _norm(tensors: dict) -> float:
    return float(np.sqrt(sum(float((t.double() ** 2).sum()) for t in tensors.values())))


def _bf16(a) -> np.ndarray:
    """a rounded to bf16, as f32 (what both packages receive)."""
    return np.asarray(jnp.asarray(a).astype(BF16).astype(jnp.float32))


def _cast(tree):
    return jax.tree_util.tree_map(lambda t: t.astype(BF16), tree)


def _draw(shapes, rng):
    """Weights for the variable shapes of a flax init, drawn in numpy (the
    jitted init would cost a compile of its own): kernels U(+-1/sqrt(fan
    in)), as torch.nn.Linear's, biases U(+-0.1), LayerNorm scales 1 +
    N(0, 0.1^2), the mesh seeds N(0, 0.1^2)."""

    def leaf(path, shape):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            bound = shape.shape[0] ** -0.5
            return rng.uniform(-bound, bound, shape.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.normal(size=shape.shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return rng.uniform(-0.1, 0.1, shape.shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.cache
def _reference():
    """The JAX package's bf16 and f32 forward, NormalizedMSELoss(normalize=
    True) and its gradients on one seeded batch at 30°, with its weights."""
    lat_lons = _grid(30.0)
    ref = jax_forecast.GraphWeatherForecaster(lat_lons, **CONFIG)
    rng = np.random.default_rng(30)
    variables = _draw(jax.eval_shape(ref.init, jax.random.PRNGKey(0)), rng)
    x = rng.normal(size=(2, len(lat_lons), FEATURES + AUX)).astype(np.float32)
    y = rng.normal(size=(2, len(lat_lons), FEATURES)).astype(np.float32)
    variance = rng.uniform(0.5, 2.0, FEATURES).astype(np.float32)
    loss = JaxLoss(variance, lat_lons, normalize=True)
    out = {}
    for name, fwd in (("bf16", ref.forward_fn(compute_dtype=BF16)), ("f32", ref.forward_fn())):

        def objective(v, fwd=fwd):
            pred = fwd(v, x)
            return loss(pred, y), pred

        (value, pred), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(variables)
        out[name] = dict(
            pred=np.asarray(pred),
            loss=float(value),
            grads=from_jax_params(jax.tree_util.tree_map(np.asarray, grads)),
        )
    return dict(ref=ref, lat_lons=lat_lons, variables=variables, x=x, y=y, variance=variance, **out)


def _port(use_checkpointing=False):
    r = _reference()
    model = GraphWeatherForecaster(
        r["lat_lons"], **CONFIG, use_checkpointing=use_checkpointing, device="cpu"
    )
    model.module.load_state_dict(from_jax_params(r["variables"]))
    loss = NormalizedMSELoss(r["variance"], r["lat_lons"], normalize=True, device="cpu")
    return model, loss


def _grads(model, loss):
    r = _reference()
    model.module.zero_grad(set_to_none=True)
    fwd = model.forward_fn(compute_dtype=torch.bfloat16)
    value = loss(fwd(torch.from_numpy(r["x"])), torch.from_numpy(r["y"]))
    value.backward()
    return value.item(), {k: p.grad for k, p in model.module.named_parameters()}


# --- the sums ------------------------------------------------------------------------


def _edge_rows(rng, n_edges, width=WIDTH):
    return _bf16(rng.normal(size=(n_edges, width)) * 4.0)


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_segment_sum_plain_is_xla_segment_sum(order):
    """S's plain version over build_flat_csr against jax.ops.segment_sum in
    bf16 (edge order, every partial sum rounded), up to 120 edges a node."""
    rng = np.random.default_rng(1)
    ids = np.repeat(np.arange(40), rng.integers(0, 121, size=40)).astype(np.int32)
    if order == "shuffled":
        ids = rng.permutation(ids)
    rows = _edge_rows(rng, ids.size)
    want = jax.ops.segment_sum(jnp.asarray(rows).astype(BF16), ids, num_segments=40)
    csr = [torch.from_numpy(a) for a in scatter.build_flat_csr(ids, 40)]
    got = scatter.segment_sum_bf16(torch.from_numpy(rows).bfloat16(), *csr)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_segment_sum_plain_is_the_gradient_of_take():
    """S's plain version over the senders' flat CSR against the bf16
    gradient of jnp.take by sender (batched), as EdgeBlock's node terms
    receive it."""
    rng = np.random.default_rng(2)
    senders = rng.integers(0, 30, size=900).astype(np.int32)
    table = jnp.zeros((2, 30, WIDTH), BF16)
    grad = np.stack([_edge_rows(rng, 900), _edge_rows(rng, 900)])
    _, vjp = jax.vjp(lambda t: jnp.take(t, senders, axis=-2), table)
    (want,) = vjp(jnp.asarray(grad).astype(BF16))
    csr = [torch.from_numpy(a) for a in scatter.build_flat_csr(senders, 30)]
    got = scatter.segment_sum_bf16(torch.from_numpy(grad).bfloat16(), *csr)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_segment_sum_gradient_is_xla_segment_sum():
    """S's gradient with `nodes` is the bf16 gradient of jax.ops.segment_sum
    (a gather by node), bit for bit; rows that need a gradient without
    `nodes` raise, as they would on the card."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 25, size=400).astype(np.int32)
    rows, grad = _edge_rows(rng, ids.size), _edge_rows(rng, 25)
    _, vjp = jax.vjp(lambda r: jax.ops.segment_sum(r, ids, num_segments=25),
                     jnp.asarray(rows).astype(BF16))
    (want,) = vjp(jnp.asarray(grad).astype(BF16))
    csr = [torch.from_numpy(a) for a in scatter.build_flat_csr(ids, 25)]
    leaf = torch.from_numpy(rows).bfloat16().requires_grad_()
    scatter.segment_sum_bf16(leaf, *csr, nodes=torch.from_numpy(ids)).backward(
        torch.from_numpy(grad).bfloat16())
    np.testing.assert_array_equal(leaf.grad.float().numpy(), np.asarray(want.astype(jnp.float32)))
    with pytest.raises(ValueError, match="nodes"):
        scatter.segment_sum_bf16(leaf, *csr)


def test_segment_softmax_bf16_is_jax():
    """GenCast's segment softmax in bf16, its sum through S over the
    receivers' flat CSR, against the JAX package's in bf16 bit for bit;
    bf16 logits without the CSR raise."""
    rng = np.random.default_rng(4)
    receivers = np.sort(rng.integers(0, 50, size=600)).astype(np.int32)
    receivers = receivers[receivers % 7 != 3]  # receivers with no edge
    logits = (rng.normal(size=(2, receivers.size, 4)) * 3.0).astype(np.float32)
    want = jax_segment_softmax(jnp.asarray(logits).astype(BF16), jnp.asarray(receivers), 50)
    csr = [torch.from_numpy(a) for a in scatter.build_flat_csr(receivers, 50)]
    args = (torch.from_numpy(logits).bfloat16(), torch.from_numpy(receivers), 50)
    got = segment_softmax(*args, csr)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    with pytest.raises(TypeError, match="receiver_csr"):
        segment_softmax(*args)


def test_table_sum_is_padded_csr_agg():
    """The bf16 padded-table sum (f32 sums rounded once) against the JAX
    package's padded_csr_agg in bf16."""
    rng = np.random.default_rng(3)
    receivers = np.repeat(np.arange(50), rng.integers(1, 17, size=50)).astype(np.int32)
    ids, mask = scatter.build_padded_csr(receivers, 50)
    rows = np.stack([_edge_rows(rng, receivers.size), _edge_rows(rng, receivers.size)])
    want = jax_scatter.padded_csr_agg(jnp.asarray(rows).astype(BF16), ids, mask)
    got = scatter.padded_csr_agg(torch.from_numpy(rows).bfloat16(), torch.from_numpy(ids),
                                 torch.from_numpy(mask))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# --- the blocks and the forecaster ----------------------------------------------------


def _block_case(kind, graph_name):
    """(JAX bf16 out, JAX f32 out, port bf16 out) of the forecaster's
    EdgeBlock or NodeBlock on one of its graphs, with its weights."""
    r = _reference()
    ref = r["ref"]
    model, _ = _port()
    jax_graph = getattr(ref, graph_name)
    port_graph = getattr(model, graph_name)
    rng = np.random.default_rng(4)
    n_src, n_dst, n_edges = jax_graph.n_senders, jax_graph.n_receivers, int(jax_graph.senders.size)
    x_src = _bf16(rng.normal(size=(1, n_src, WIDTH)))
    x_dst = _bf16(rng.normal(size=(1, n_dst, WIDTH)))
    edges = _bf16(rng.normal(size=(1, n_edges, WIDTH)))
    owner = "Encoder_0" if graph_name == "g2m" else "Processor_0"
    path = ["GraphProcessorBlock_0"] if graph_name == "g2m" else ["GraphProcessor_0", "GraphProcessorBlock_0"]
    params = r["variables"]["params"][owner]
    for name in path:
        params = params[name]
    params = params[f"{kind}_0"]
    if kind == "EdgeBlock":
        module = jax_blocks.EdgeBlock(WIDTH, WIDTH, 2, "LayerNorm")
        args = (x_src, x_dst, edges)
        port = EdgeBlock(WIDTH, WIDTH, WIDTH, WIDTH, 2, "LayerNorm")
    else:
        module = jax_blocks.NodeBlock(WIDTH, WIDTH, 2, "LayerNorm")
        args = (x_dst, edges)
        port = NodeBlock(WIDTH, WIDTH, WIDTH, 2, "LayerNorm")

    def apply(variables, *a):
        # In its own dtype: an f32 upcast inside the jit would let XLA keep
        # the block's last add (the residual) in f32.
        return module.apply({"params": variables}, *a, jax_graph)

    want16 = jax.jit(apply)(_cast(params), *(jnp.asarray(a).astype(BF16) for a in args))
    want16 = want16.astype(jnp.float32)
    want32 = jax.jit(apply)(params, *args)
    port.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        got = torch.func.functional_call(
            port, Bf16Params(port)(),
            (*(torch.from_numpy(a).bfloat16() for a in args), port_graph),
        )
    return np.asarray(want16), np.asarray(want32), got.float().numpy()


@pytest.mark.parametrize(
    "kind,graph_name",
    [("EdgeBlock", "g2m"), ("EdgeBlock", "latent"), ("NodeBlock", "g2m"), ("NodeBlock", "latent")],
)
def test_block_matches_jax_bf16(kind, graph_name):
    """The forecaster's first g2m and latent blocks on bf16 inputs: on g2m
    the NodeBlock sums its receivers' up to 77 edges in edge order (S), on
    the latent graph through its padded table."""
    want16, want32, got = _block_case(kind, graph_name)
    assert got.shape == want16.shape
    assert _rmse(got, want16) <= RULE * _rmse(want16, want32)


def test_forward_matches_jax_bf16():
    r = _reference()
    model, _ = _port()
    with torch.no_grad():
        got = model.forward_fn(compute_dtype=torch.bfloat16)(torch.from_numpy(r["x"]))
    assert got.dtype == torch.float32 and got.shape == r["bf16"]["pred"].shape
    want, f32 = r["bf16"]["pred"], r["f32"]["pred"]
    assert _rmse(got.numpy(), want) <= RULE * _rmse(want, f32)


def test_loss_and_gradients_match_jax_bf16():
    r = _reference()
    model, loss = _port()
    value, grads = _grads(model, loss)
    want, f32 = r["bf16"], r["f32"]
    assert abs(value - want["loss"]) <= RULE * abs(want["loss"] - f32["loss"])
    assert set(grads) == set(want["grads"])
    assert all(g.dtype == torch.float32 for g in grads.values())
    to_jax = _norm({k: grads[k] - want["grads"][k] for k in grads})
    assert to_jax <= RULE * _norm({k: want["grads"][k] - f32["grads"][k] for k in grads})


def test_checkpointing_gives_bit_equal_bf16_gradients():
    plain, loss = _port()
    remat, _ = _port(use_checkpointing=True)
    want = _grads(plain, loss)
    got = _grads(remat, loss)
    assert got[0] == want[0]
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])


def test_bf16_train_step_keeps_f32_parameters():
    """One make_train_step step (clip 1 + AdamW at lr 1e-3) through the bf16
    forward_fn: the parameters and the optimizer's moments stay f32, every
    parameter moves, the CPU path launches no kernel."""
    r = _reference()
    model, loss = _port()
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    counts = (fused_mlp.BF16_LAUNCHES, fused_mlp.BF16_BACKWARD_LAUNCHES, scatter.LAUNCHES)
    step = make_train_step(model.module.parameters(), model.forward_fn(compute_dtype=torch.bfloat16),
                           loss, make_optimizer(1e-3))
    value = step(torch.from_numpy(r["x"]), torch.from_numpy(r["y"]))
    assert torch.isfinite(value)
    after = model.module.state_dict()
    assert all(t.dtype == torch.float32 for t in after.values())
    assert not any(torch.equal(after[k], before[k]) for k in before)
    moments = [t for state in step.optimizer.state.values() for t in state.values()
               if torch.is_tensor(t) and t.dim() > 0]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    assert (fused_mlp.BF16_LAUNCHES, fused_mlp.BF16_BACKWARD_LAUNCHES, scatter.LAUNCHES) == counts


def test_bf16_rollout_is_finite():
    r = _reference()
    model, _ = _port()
    rollout = make_rollout_fn(model.forward_fn(compute_dtype=torch.bfloat16), 3)
    traj = rollout(torch.from_numpy(r["x"][:1]))
    assert traj.shape == (3, 1, len(r["lat_lons"]), FEATURES) and traj.dtype == torch.float32
    assert torch.isfinite(traj).all()


def test_other_compute_dtypes_raise():
    model = GraphWeatherForecaster(_grid(30.0), **CONFIG, device="cpu")
    with pytest.raises(NotImplementedError, match=TF32_TODO):
        model.forward_fn(compute_dtype=torch.float16)
