"""The port's GraphWeatherForecaster against the JAX package, on the CPU.

Both packages get the same weights (flax init -> convert.from_jax_params)
and the same numpy inputs. Every module runs its plain PyTorch path here
(the fused edge kernel's CPU twin). Tolerances: atol 2e-5 for f32 forwards
that differ only in summation order; the reference golden at
tests/test_parity.py's limits (per-variable RMSE < 1e-5, max < 1e-4).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.convert import convert_forecaster
from graph_weather_tpu.models import forecast as jax_forecast
from graph_weather_tpu.models import layers as jax_layers
from graph_weather_tpu.models.losses import NormalizedMSELoss as JaxLoss
from graph_weather_tpu.nn import graph_blocks as jax_blocks
from graph_weather_tpu.train.rollout import jit_rollout
from graph_weather_tpu_torch import GraphWeatherForecaster, NormalizedMSELoss, from_jax_params
from graph_weather_tpu_torch.ops import edge_mlp
from graph_weather_tpu_torch.train.rollout import make_rollout_fn

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens" / "forecaster_small.npz"
ATOL = 2e-5
# The golden's small config: 4 features + 2 aux, widths 16, 2 blocks.
CONFIG = dict(
    feature_dim=4, aux_dim=2, node_dim=16, edge_dim=16, num_blocks=2,
    hidden_dim_processor_node=16, hidden_dim_processor_edge=16, hidden_dim_decoder=8,
)
WIDTH = 16


def _grid(spacing):
    return [
        (float(a), float(b))
        for a in np.arange(-90.0, 90.0, spacing)
        for b in np.arange(0.0, 360.0, spacing)
    ]


@pytest.fixture(scope="module")
def jax_params():
    """One set of weights; the mesh (and so every parameter shape) does not
    depend on the grid, so it serves both grids."""
    model = jax_forecast.GraphWeatherForecaster(_grid(30.0), **CONFIG)
    params = model.init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=[30.0, 4.0], ids=["grid30", "grid4"])
def models(request, jax_params):
    lat_lons = _grid(request.param)
    ref = jax_forecast.GraphWeatherForecaster(lat_lons, **CONFIG)
    port = GraphWeatherForecaster(lat_lons, **CONFIG, device="cpu")
    port.module.load_state_dict(from_jax_params(jax_params))
    rng = np.random.default_rng(int(request.param))
    return ref, port, jax_params["params"], rng


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port_out, ref_out, atol=ATOL):
    np.testing.assert_allclose(port_out.detach().numpy(), np.asarray(ref_out), atol=atol)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_converted_state_dict_matches_module(jax_params):
    """from_jax_params gives exactly the port module's names and shapes."""
    port = GraphWeatherForecaster(_grid(30.0), **CONFIG, device="cpu")
    expected = {k: tuple(v.shape) for k, v in port.module.state_dict().items()}
    converted = {k: tuple(v.shape) for k, v in from_jax_params(jax_params).items()}
    assert converted == expected


def test_forecaster_matches_jax(models):
    ref, port, params, rng = models
    x = _rand(rng, 2, ref.num_grid_nodes, 6)
    out = port(_t(x))
    assert out.shape == (2, ref.num_grid_nodes, 4)
    _close(out, ref.apply({"params": params}, jnp.asarray(x)))


def test_edge_block_matches_jax(models):
    ref, port, params, rng = models
    p = params["Processor_0"]["GraphProcessor_0"]["GraphProcessorBlock_0"]["EdgeBlock_0"]
    x = _rand(rng, 2, ref.latent.n_senders, WIDTH)
    e = _rand(rng, 2, int(ref.latent.senders.shape[0]), WIDTH)
    block = jax_blocks.EdgeBlock(WIDTH, WIDTH)
    want = jax.jit(lambda x, e: block.apply({"params": p}, x, x, e, ref.latent))(x, e)
    got = port.module.Processor_0.GraphProcessor_0.GraphProcessorBlock_0.EdgeBlock_0(
        _t(x), _t(x), _t(e), port.latent
    )
    _close(got, want)


def test_zero_destination_edge_block_matches_jax(models):
    """The decoder's m2g edge update with dst_is_zero (x_dst=None)."""
    ref, port, params, rng = models
    p = params["Decoder_0"]["GraphProcessorBlock_0"]["EdgeBlock_0"]
    x_mesh = _rand(rng, 1, ref.m2g.n_senders, WIDTH)
    zeros = np.zeros((1, ref.m2g.n_receivers, WIDTH), np.float32)
    e = _rand(rng, int(ref.m2g.senders.shape[0]), WIDTH)
    block = jax_blocks.EdgeBlock(WIDTH, WIDTH, dst_is_zero=True)
    want = jax.jit(
        lambda x, z, e: block.apply({"params": p}, x, z, jnp.broadcast_to(e, (1,) + e.shape), ref.m2g)
    )(x_mesh, zeros, e)
    got = port.module.Decoder_0.GraphProcessorBlock_0.EdgeBlock_0(
        _t(x_mesh), None, _t(e), port.m2g
    )
    _close(got, want)


@pytest.mark.parametrize("graph", ["latent", "g2m"])
def test_node_block_matches_jax(models, graph):
    """Latent: padded-CSR aggregation. g2m: CSR on the 30° grid, segment-sum
    on the 4° grid, whose polar cells receive more than 16 points."""
    ref, port, params, rng = models
    if graph == "latent":
        p = params["Processor_0"]["GraphProcessor_0"]["GraphProcessorBlock_1"]["NodeBlock_0"]
        port_block = port.module.Processor_0.GraphProcessor_0.GraphProcessorBlock_1.NodeBlock_0
    else:
        p = params["Encoder_0"]["GraphProcessorBlock_0"]["NodeBlock_0"]
        port_block = port.module.Encoder_0.GraphProcessorBlock_0.NodeBlock_0
    jax_graph, port_graph = getattr(ref, graph), getattr(port, graph)
    assert (port_graph.csr_edge_ids is None) == (jax_graph.csr_edge_ids is None)
    x = _rand(rng, 2, jax_graph.n_receivers, WIDTH)
    e = _rand(rng, 2, int(jax_graph.senders.shape[0]), WIDTH)
    block = jax_blocks.NodeBlock(WIDTH, WIDTH)
    want = jax.jit(lambda x, e: block.apply({"params": p}, x, e, jax_graph))(x, e)
    _close(port_block(_t(x), _t(e), port_graph), want)


def test_encoder_matches_jax(models):
    ref, port, params, rng = models
    x = _rand(rng, 2, ref.num_grid_nodes, 6)
    enc = jax_layers.Encoder(
        input_dim=6, node_dim=WIDTH, edge_dim=WIDTH, hidden_dim_processor_node=WIDTH,
        hidden_dim_processor_edge=WIDTH, n_mesh=ref.latent.n_senders,
    )
    want_mesh, want_edges = jax.jit(
        lambda x: enc.apply({"params": params["Encoder_0"]}, x, ref.g2m, ref.latent)
    )(x)
    got_mesh, got_edges = port.module.Encoder_0(_t(x), port.g2m, port.latent)
    _close(got_mesh, want_mesh)
    _close(got_edges, want_edges)


@pytest.mark.parametrize("edges_batched", [False, True], ids=["broadcast_e", "batched_e"])
def test_processor_matches_jax(models, edges_batched):
    ref, port, params, rng = models
    x = _rand(rng, 2, ref.latent.n_senders, WIDTH)
    n_edges = int(ref.latent.senders.shape[0])
    e = _rand(rng, *((2, n_edges, WIDTH) if edges_batched else (n_edges, WIDTH)))
    proc = jax_layers.Processor(
        node_dim=WIDTH, edge_dim=WIDTH, num_blocks=2,
        hidden_dim_processor_node=WIDTH, hidden_dim_processor_edge=WIDTH,
    )
    want = jax.jit(
        lambda x, e: proc.apply({"params": params["Processor_0"]}, x, e, ref.latent)
    )(x, e)
    _close(port.module.Processor_0(_t(x), _t(e), port.latent), want)


def test_decoder_matches_jax(models):
    ref, port, params, rng = models
    x = _rand(rng, 2, ref.m2g.n_senders, WIDTH)
    dec = jax_layers.Decoder(
        output_dim=4, node_dim=WIDTH, edge_dim=WIDTH, hidden_dim_processor_node=WIDTH,
        hidden_dim_processor_edge=WIDTH, hidden_dim_decoder=8,
    )
    want = jax.jit(lambda x: dec.apply({"params": params["Decoder_0"]}, x, ref.m2g))(x)
    _close(port.module.Decoder_0(_t(x), port.m2g), want)


def test_rollout_matches_jax(models):
    ref, port, params, rng = models
    x = _rand(rng, 1, ref.num_grid_nodes, 6)
    want = jit_rollout(ref.forward_fn(), 3)({"params": params}, jnp.asarray(x))
    got = make_rollout_fn(port, 3)(_t(x))
    assert got.shape == (3, 1, ref.num_grid_nodes, 4)
    _close(got, want, atol=3 * ATOL)  # three chained forwards
    final = make_rollout_fn(port, 3, collect=False)(_t(x))
    _close(final, want[-1], atol=3 * ATOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_normalized_mse_loss_matches_jax(normalize):
    rng = np.random.default_rng(3)
    lat_lons = _grid(30.0)
    variance = rng.uniform(0.5, 2.0, size=4).astype(np.float32)
    pred, target = _rand(rng, 2, len(lat_lons), 4), _rand(rng, 2, len(lat_lons), 4)
    want = JaxLoss(variance, lat_lons, normalize=normalize)(pred, target)
    got = NormalizedMSELoss(variance, lat_lons, normalize=normalize, device="cpu")(
        _t(pred), _t(target)
    )
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.skipif(not GOLDEN.exists(), reason="golden not generated")
def test_forecaster_matches_torch_reference_golden():
    """The committed reference golden through the JAX package's converter
    and from_jax_params, with the reference's latent-graph ordering."""
    data = np.load(GOLDEN)
    (lat_step, lon_step, feature_dim, aux_dim, node_dim, edge_dim,
     num_blocks, hid_node, hid_edge, hid_dec) = data["__config__"]
    lat_lons = [
        (float(a), float(b))
        for a in np.arange(-90.0, 90.0, lat_step)
        for b in np.arange(0.0, 360.0, lon_step)
    ]
    model = GraphWeatherForecaster(
        lat_lons, feature_dim=int(feature_dim), aux_dim=int(aux_dim),
        node_dim=int(node_dim), edge_dim=int(edge_dim), num_blocks=int(num_blocks),
        hidden_dim_processor_node=int(hid_node), hidden_dim_processor_edge=int(hid_edge),
        hidden_dim_decoder=int(hid_dec), latent_graph_order="reference", device="cpu",
    )
    sd = {k: data[k] for k in data.files if not k.startswith("__")}
    model.module.load_state_dict(from_jax_params(convert_forecaster(sd, num_blocks=int(num_blocks))))
    out = model(_t(data["__input__"])).numpy()
    expected = data["__output__"]
    assert out.shape == expected.shape
    per_var_rmse = np.sqrt(((out - expected) ** 2).mean(axis=(0, 1)))
    assert per_var_rmse.max() < 1e-5, per_var_rmse
    assert np.abs(out - expected).max() < 1e-4


def test_init_is_seeded_torch_linear():
    """init(generator): same seed, same weights; torch-Linear bounds;
    unit LayerNorm, zero mesh seeds."""
    model = GraphWeatherForecaster(_grid(30.0), **CONFIG, device="cpu")
    def init(seed):
        sd = model.init(torch.Generator().manual_seed(seed))
        return {k: v.clone() for k, v in sd.items()}

    first, other, again = init(0), init(1), init(0)
    assert all(torch.equal(first[k], again[k]) for k in first)
    kernel = "Encoder_0.MLP_0.TorchLinear_0.kernel"
    assert not torch.equal(first[kernel], other[kernel])
    for name, value in first.items():
        if "TorchLinear" in name:
            fan_in = first[name.rsplit(".", 1)[0] + ".kernel"].shape[0]
            assert value.abs().max() <= fan_in**-0.5
        if "LayerNorm" in name:
            assert torch.all(value == (1.0 if name.endswith("weight") else 0.0))
    assert torch.all(first["Encoder_0.mesh_nodes"] == 0)
    assert edge_mlp.LAUNCHES == 0  # the CPU path never counts a launch
    assert torch.isfinite(model(torch.zeros(1, model.num_grid_nodes, 6))).all()


@pytest.mark.parametrize(
    "option",
    [
        dict(constraint_type="additive"),
        dict(use_thermalizer=True),
        dict(norm_type="RMSNorm"),
        dict(hidden_layers_processor_edge=1),
        dict(hidden_layers_processor_edge=3),
    ],
    ids=["constraint", "thermalizer", "rmsnorm", "edge_layers_1", "edge_layers"],
)
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        GraphWeatherForecaster(_grid(30.0), **{**CONFIG, **option}, device="cpu")


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import graph_weather_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'graph_weather_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'graph_weather_tpu')]\n"
        "assert not bad, bad\n"
        "print('modules', len([m for m in sys.modules if m.startswith('graph_weather_tpu_torch')]))\n"
    )
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "modules" in proc.stdout


def test_chip_smoke_fails_without_gpu(tmp_path):
    """No CUDA device: non-zero exit and no result line, both in the repo
    and in a directory that holds chip_smoke.py alone."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        proc = _run([str(script)], cwd)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
