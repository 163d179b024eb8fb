"""The port's GenCast denoiser, sampler and rollout against the JAX package,
on the CPU.

Both packages get the same weights (a flax tree -> convert.from_jax_params)
and the same numpy inputs and noise. Sizes are those of the small GenCast
tests: a 32 x 16 grid, splits 2, 2 hops, widths 16, 2-3 blocks, 2 heads.
Tolerances:
  * modules: atol 2e-5 (f32, summation order only);
  * Denoiser, segment path with edge features: atol 1e-4;
  * Denoiser, clustered path: RMSE < 1e-4 and max 1e-3, the JAX package's
    own limit for its clustered-vs-segment test. The decoder ends in a
    LayerNorm over the 2 output channels, which amplifies f32 order
    differences to a few 1e-4;
  * goldens: per-variable RMSE < 1e-5 (gencast_small) and RMSE < 1e-4
    (sampler_traj_small), the limits of tests/test_parity.py;
  * sampler against JAX: RMSE < 1e-4; isht: atol 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.convert import convert_denoiser
from graph_weather_tpu.models.gencast import Denoiser as JaxDenoiser
from graph_weather_tpu.models.gencast import Sampler as JaxSampler
from graph_weather_tpu.models.gencast import modules as jax_modules
from graph_weather_tpu.models.gencast.rollout import default_update_fn as jax_update
from graph_weather_tpu.ops.sht import isht as jax_isht
from graph_weather_tpu_torch import Denoiser, Sampler, from_jax_params, make_ar_rollout_fn
from graph_weather_tpu_torch.models.gencast import modules
from graph_weather_tpu_torch.models.gencast.denoiser import DenoiserConfig
from graph_weather_tpu_torch.models.gencast.rollout import default_update_fn
from graph_weather_tpu_torch.ops import clustered_flash
from graph_weather_tpu_torch.ops.sht import generate_isotropic_noise, isht

torch.set_num_threads(1)
GOLDENS = Path(__file__).resolve().parent / "goldens"
GENCAST_GOLDEN = GOLDENS / "gencast_small.npz"
SAMPLER_GOLDEN = GOLDENS / "sampler_traj_small.npz"
ATOL = 2e-5
CLUSTERED = dict(
    grid_lon=np.arange(0.0, 360.0, 360.0 / 32), grid_lat=np.linspace(-90.0, 90.0, 16),
    input_features_dim=3, output_features_dim=2, hidden_dims=(16, 16), num_blocks=2,
    num_heads=2, splits=2, num_hops=2, use_edges_features=False,
    attention_impl="clustered_flash",
)


def _golden_kwargs(data):
    (_, _, f_in, f_out, hid, n_hidden, num_blocks, num_heads,
     splits, num_hops, use_edges) = data["__config__"]
    return dict(
        grid_lon=data["__grid_lon__"], grid_lat=data["__grid_lat__"],
        input_features_dim=int(f_in), output_features_dim=int(f_out),
        hidden_dims=(int(hid),) * int(n_hidden), num_blocks=int(num_blocks),
        num_heads=int(num_heads), splits=int(splits), num_hops=int(num_hops),
        use_edges_features=bool(use_edges), mesh_orientation="graphcast",
        node_layout="reference",
    )


def _golden_params(data):
    kw = _golden_kwargs(data)
    sd = {k: data[k] for k in data.files if not k.startswith("__")}
    return convert_denoiser(sd, num_blocks=kw["num_blocks"], mlp_hidden_dims=len(kw["hidden_dims"]))


@pytest.fixture(scope="module")
def segment_models():
    """The gencast_small config (segment path, k-hop edge features) with the
    golden's converted weights, in both packages."""
    data = np.load(GENCAST_GOLDEN)
    kw = _golden_kwargs(data)
    params = jax.tree_util.tree_map(np.asarray, _golden_params(data))
    port = Denoiser(**kw, device="cpu")
    port.module.load_state_dict(from_jax_params(params))
    return JaxDenoiser(**kw), port, params, data


@pytest.fixture(scope="module")
def clustered_models():
    ref = JaxDenoiser(**CLUSTERED)
    params = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    port = Denoiser(**CLUSTERED, device="cpu")
    port.module.load_state_dict(from_jax_params(params))
    return ref, port, params


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol)


def test_converted_state_dict_matches_module(segment_models, clustered_models):
    """from_jax_params gives exactly the port module's names and shapes, on
    both attention paths (the edge linear only where edge features run)."""
    for _, port, params, *_ in (segment_models, clustered_models):
        expected = {k: tuple(v.shape) for k, v in port.module.state_dict().items()}
        converted = {k: tuple(v.shape) for k, v in from_jax_params(params).items()}
        assert converted == expected


def test_fourier_embedding_and_cond_norm_match_jax(segment_models):
    _, port, params, _ = segment_models
    proc = params["params"]["GenCastProcessor_0"]
    rng = np.random.default_rng(0)
    t = _rand(rng, 3, 1)
    want = jax_modules.FourierEmbedding(16).apply({"params": proc["FourierEmbedding_0"]}, t)
    _close(port.module.GenCastProcessor_0.FourierEmbedding_0(_t(t)), want)
    x, cond = _rand(rng, 3, 40, 16), _rand(rng, 3, 1, 16)
    block = proc["CondTransformerBlock_1"]
    want = jax_modules.ConditionalLayerNorm(16).apply(
        {"params": block["ConditionalLayerNorm_0"]}, x, cond
    )
    got = port.module.GenCastProcessor_0.CondTransformerBlock_1.ConditionalLayerNorm_0(_t(x), _t(cond))
    _close(got, want)


@pytest.mark.parametrize("block", [0, 2], ids=["concat", "last_mean_heads"])
def test_transformer_conv_segment_matches_jax(segment_models, block):
    """Segment branch with edge features (q/k/v, edge linear, skip, beta)."""
    ref, port, params, _ = segment_models
    p = params["params"]["GenCastProcessor_0"][f"CondTransformerBlock_{block}"]
    last = block == 2
    conv = jax_modules.GraphTransformerConv(16 if last else 8, 2, concat=not last)
    rng = np.random.default_rng(block)
    x = _rand(rng, 2, ref.khop.n_receivers, 16)
    e = _rand(rng, int(ref.khop.senders.shape[0]), 16)
    want = jax.jit(lambda x, e: conv.apply({"params": p["GraphTransformerConv_0"]}, x, ref.khop, e))(x, e)
    port_conv = getattr(port.module.GenCastProcessor_0, f"CondTransformerBlock_{block}").GraphTransformerConv_0
    # The port's k-hop graph may order senders differently within a
    # receiver; the per-edge inputs follow the port's edge order.
    order = _edge_order(port.khop, ref.khop)
    _close(port_conv(_t(x), port.khop, _t(e[order])), want)


def _edge_order(port_graph, ref_graph):
    """Index into the JAX graph's edges for each edge of the port's graph."""
    ref_key = np.asarray(ref_graph.receivers, np.int64) * 10**6 + np.asarray(ref_graph.senders)
    port_key = port_graph.receivers.numpy().astype(np.int64) * 10**6 + port_graph.senders.numpy()
    pos = np.argsort(ref_key)
    return pos[np.searchsorted(ref_key[pos], port_key)]


@pytest.mark.parametrize("block", [0, 1], ids=["concat_c8", "last_c16"])
def test_transformer_conv_clustered_matches_jax(clustered_models, block):
    """Clustered branch: the plain K3a here, the Pallas kernel in the
    interpreter there; c = 8 (concatenated heads) and c = 16 (last block)."""
    ref, port, params = clustered_models
    p = params["params"]["GenCastProcessor_0"][f"CondTransformerBlock_{block}"]
    last = block == 1
    conv = jax_modules.GraphTransformerConv(16 if last else 8, 2, concat=not last, use_edge_features=False)
    x = _rand(np.random.default_rng(block), 2, ref.khop.n_receivers, 16)
    want = jax.jit(lambda x: conv.apply({"params": p["GraphTransformerConv_0"]}, x, ref.khop))(x)
    port_conv = getattr(port.module.GenCastProcessor_0, f"CondTransformerBlock_{block}").GraphTransformerConv_0
    assert port.khop.cluster_ids is not None
    _close(port_conv(_t(x), port.khop), want)


def test_denoiser_segment_matches_jax(segment_models):
    ref, port, params, data = segment_models
    args = (data["__corrupted__"], data["__prev__"], data["__noise__"])
    want = np.asarray(ref.forward_fn()(params, *args))
    got = port(*args)
    assert got.shape == want.shape == (2, 32, 16, 2)
    _close(got, want, atol=1e-4)


def test_denoiser_clustered_matches_jax(clustered_models):
    ref, port, params = clustered_models
    rng = np.random.default_rng(7)
    tgt, prev = _rand(rng, 1, 32, 16, 2), _rand(rng, 1, 32, 16, 6)
    noise = np.full((1, 1), 0.5, np.float32)
    want = np.asarray(ref.forward_fn()(params, tgt, prev, noise))
    before = clustered_flash.LAUNCHES
    got = port(tgt, prev, noise).numpy()
    assert clustered_flash.LAUNCHES == before  # CPU: the plain version
    assert np.sqrt(((got - want) ** 2).mean()) < 1e-4
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_denoiser_matches_torch_reference_golden(segment_models):
    """The gencast_small golden through the JAX package's converter and
    from_jax_params (tests/test_parity.py's limit)."""
    _, port, _, data = segment_models
    out = port(data["__corrupted__"], data["__prev__"], data["__noise__"]).numpy()
    expected = data["__output__"]
    assert out.shape == expected.shape
    per_var_rmse = np.sqrt(((out - expected) ** 2).mean(axis=(0, 1, 2)))
    assert per_var_rmse.max() < 1e-5, per_var_rmse


@pytest.mark.parametrize("lmax,nlat,nlon", [(16, 16, 32), (8, 9, 16)])
def test_isht_matches_jax(lmax, nlat, nlon):
    rng = np.random.default_rng(lmax)
    cc, cs = _rand(rng, 3, lmax, lmax), _rand(rng, 3, lmax, lmax)
    want = jax_isht(jnp.asarray(cc), jnp.asarray(cs), nlat, nlon)
    _close(isht(_t(cc), _t(cs), nlat, nlon), want, atol=1e-5)


def test_isotropic_noise_synthesis():
    """The noise is isht of the generator's coefficients (the JAX
    construction, on the same numbers): unit variance, [lon, lat, S]."""
    gen = torch.Generator().manual_seed(0)
    noise = generate_isotropic_noise(gen, 32, 16, num_samples=64)
    assert noise.shape == (32, 16, 64)
    assert abs(noise.var().item() - 1.0) < 0.1
    gen.manual_seed(0)
    tri = np.tril(np.ones((16, 16), np.float32))
    sigma = (4.0 * np.pi) ** 0.5 / 16
    cc = torch.randn((2, 16, 16), generator=gen).numpy() * sigma * tri
    cs = torch.randn((2, 16, 16), generator=gen).numpy() * sigma * tri
    want = np.transpose(np.asarray(jax_isht(jnp.asarray(cc), jnp.asarray(cs), 16, 32)), (2, 1, 0))
    _close(generate_isotropic_noise(torch.Generator().manual_seed(0), 32, 16, num_samples=2), want, atol=1e-5)
    with pytest.raises(ValueError, match="2N x N"):
        generate_isotropic_noise(gen, 33, 16)


def test_sample_injected_matches_jax(segment_models):
    """4 DPMSolver++2S steps (5 evaluations) on the same numpy noise."""
    ref, port, params, data = segment_models
    rng = np.random.default_rng(11)
    prev = data["__prev__"][:1]
    noises = _rand(rng, 4, 1, 32, 16, 2)
    want = np.asarray(
        jax.jit(JaxSampler(num_steps=4).sample_fn_injected(ref))(params, prev, noises[0], noises[1:])
    )
    got = Sampler(num_steps=4, device="cpu").sample_injected(port, prev, noises[0], noises[1:]).numpy()
    assert got.shape == want.shape
    assert np.sqrt(((got - want) ** 2).mean()) < 1e-4


@pytest.mark.skipif(not SAMPLER_GOLDEN.exists(), reason="golden not generated")
def test_sampler_trajectory_matches_torch_reference_golden():
    """The reference run's noise draws replayed through sample_injected on
    the golden's converted weights (tests/test_parity.py's limit)."""
    data = np.load(SAMPLER_GOLDEN)
    port = Denoiser(**_golden_kwargs(data), device="cpu")
    port.module.load_state_dict(from_jax_params(_golden_params(data)))
    noises = data["__noises__"][:, None]  # [S, 1, lon, lat, F]
    sampler = Sampler(num_steps=int(data["__num_steps__"][0]), device="cpu")
    out = sampler.sample_injected(port, data["__prev__"], noises[0], noises[1:]).numpy()
    expected = data["__output__"]
    assert out.shape == expected.shape
    assert np.sqrt(((out - expected) ** 2).mean()) < 1e-4


def test_sample_and_rollout(clustered_models):
    """sample(): 2 (N - 2) + 1 denoiser evaluations, finite; the rollout
    shifts the conditioning window with default_update_fn."""
    _, port, _ = clustered_models
    calls = []

    class Counting:
        def __init__(self, den):
            self.__dict__.update(den.__dict__)
            self._den = den

        def __call__(self, *args):
            calls.append(1)
            return self._den(*args)

    counting = Counting(port)
    prev = _rand(np.random.default_rng(3), 2, 32, 16, 6)
    sampler = Sampler(num_steps=5, device="cpu")
    out = sampler.sample(counting, prev, torch.Generator().manual_seed(0))
    assert out.shape == (2, 32, 16, 2) and torch.isfinite(out).all()
    assert len(calls) == 2 * (5 - 2) + 1
    again = sampler.sample(port, prev, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    rollout = make_ar_rollout_fn(sampler, port, 2, device="cpu")
    traj = rollout(prev, torch.Generator().manual_seed(1))
    assert traj.shape == (2, 2, 32, 16, 2) and torch.isfinite(traj).all()
    final = make_ar_rollout_fn(sampler, port, 2, collect=False, device="cpu")(
        prev, torch.Generator().manual_seed(1)
    )
    want = default_update_fn(default_update_fn(_t(prev), traj[0]), traj[1])
    assert torch.equal(final, want)


def test_default_update_fn_matches_jax():
    rng = np.random.default_rng(4)
    prev, sample = _rand(rng, 2, 8, 4, 10), _rand(rng, 2, 8, 4, 3)
    want = jax_update(jnp.asarray(prev), jnp.asarray(sample))
    np.testing.assert_array_equal(default_update_fn(_t(prev), _t(sample)).numpy(), np.asarray(want))


def test_init_is_seeded_and_sigma_checked():
    den = Denoiser(**CLUSTERED, device="cpu")
    first = {k: v.clone() for k, v in den.init(torch.Generator().manual_seed(0)).items()}
    again = den.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(first[k], again[k]) for k in first)
    for name, value in first.items():
        if name.endswith("kernel"):
            assert value.abs().max() <= value.shape[0] ** -0.5
    args = [np.zeros((1, 32, 16, 2), np.float32), np.zeros((1, 32, 16, 6), np.float32)]
    with pytest.raises(ValueError, match="strictly positive"):
        den(*args, np.zeros((1, 1), np.float32))
    with pytest.raises(ValueError, match="shapes"):
        den(args[0], args[0], np.ones((1, 1), np.float32))
    built = DenoiserConfig(**{k: v for k, v in CLUSTERED.items()}, device="cpu").build()
    assert built.device == torch.device("cpu") and built.khop.cluster_ids is not None


def test_devices_must_agree(clustered_models):
    _, port, _ = clustered_models
    with pytest.raises(ValueError, match="one device"):
        Sampler(num_steps=3, device="meta").sample_injected(port, None, None, None)
    with pytest.raises(ValueError, match="must live there"):
        make_ar_rollout_fn(Sampler(device="cpu"), port, 1, device="meta")


@pytest.mark.parametrize(
    "option,match",
    [
        (dict(attention_impl="banded"), None),
        (dict(attention_impl="banded_flash"), None),
        (dict(attention_impl="banded_flash", compute_dtype=torch.bfloat16), "K4a and K4b in bf16"),
    ],
    ids=["banded", "banded_flash", "bf16"],
)
def test_unported_options_raise(option, match):
    """bf16 on the banded attention is not ported: forward_fn(compute_dtype=
    bfloat16) raises and names its ROADMAP item; the banded options are
    ported and build (through DenoiserConfig) the k-hop graph's band layout
    and no cluster layout."""
    kw = {**CLUSTERED, **option}
    if match is not None:
        dtype = kw.pop("compute_dtype")
        with pytest.raises(NotImplementedError, match=match):
            Denoiser(**kw, device="cpu").forward_fn(compute_dtype=dtype)
        return
    khop = DenoiserConfig(**kw, device="cpu").build().khop
    flash = option["attention_impl"] == "banded_flash"
    assert khop.cluster_ids is None and khop.band_masks is not None
    assert khop.band_flash == flash and khop.band_block == 512
    assert khop.band_w > 0 and khop.band_w % (512 if flash else 256) == 0
    assert khop.band_masks.shape == (1, 512, 512 + 2 * khop.band_w)  # 162 mesh nodes


def test_unported_entry_points_raise(clustered_models):
    _, port, _ = clustered_models
    with pytest.raises(NotImplementedError, match="from_pretrained"):
        Denoiser.from_pretrained("openclimatefix/gencast-128x64")
    args = [np.zeros((1, 32, 16, 2)), np.zeros((1, 32, 16, 6)), np.ones((1, 1))]
    with pytest.raises(NotImplementedError, match="GenDA"):
        port(*args, conditioning=np.zeros((1, 32, 16, 1)))


def test_entry_points_default_to_the_card():
    """Without device="cpu" the entry points ask for CUDA (absent here)."""
    import inspect

    from graph_weather_tpu_torch import WeightedMSELoss
    from graph_weather_tpu_torch.meshes.graphs import GraphBundle
    from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph

    for fn in (
        Denoiser.__init__, Sampler.__init__, make_ar_rollout_fn, WeightedMSELoss.__init__,
        DeviceGraph.from_bundle, GraphBundle.device_arrays,
    ):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            Denoiser(**CLUSTERED)

