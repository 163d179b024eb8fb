"""The port's FGN against the JAX package, on the CPU, in f32.

Both packages get the same weights (a flax tree -> convert.from_jax_params)
and the same numpy inputs and noise vectors. The JAX package draws each
member's noise from its PRNG key inside forward_fn and ensemble_rollout_fn;
the port takes the same draws through `noise=`. Sizes: a 32 x 16 grid,
splits 2, 2 hops, widths 16, 2 blocks (the last at c = 16, heads averaged),
2 heads, noise of 4, 8 features in and out (the decoder's final LayerNorm
over 2 channels would amplify f32 order differences: ROADMAP §3).
Tolerances:
  * modules (the processor, each branch): atol 2e-5 (f32, summation order);
  * member_fn, forward_fn, ensemble_rollout_fn: atol 1e-4;
  * the member train step: loss rtol 1e-5, each gradient within 1e-3 of its
    tensor's max|g| (tests/test_torch_gencast_train.py's rule), the
    gradient norm rtol 1e-5;
  * the fgn_small golden: per-variable RMSE < 1e-5 (tests/test_parity.py).
"""

from functools import cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graph_weather_tpu.convert import convert_fgn
from graph_weather_tpu.models.fgn import FunctionalGenerativeNetwork as JaxFGN
from graph_weather_tpu.models.fgn.model import FGNProcessor as JaxFGNProcessor
from graph_weather_tpu_torch import (
    FunctionalGenerativeNetwork,
    FunctionalGenerativeNetworkConfig,
    from_jax_params,
    make_optimizer,
    make_train_step,
)
from graph_weather_tpu_torch.models.gencast.denoiser import BANDED_BF16_TODO
from graph_weather_tpu_torch.ops import clustered_flash

torch.set_num_threads(1)
GOLDEN = Path(__file__).resolve().parent / "goldens" / "fgn_small.npz"
ATOL, MODEL_ATOL = 2e-5, 1e-4
BASE = dict(
    grid_lon=np.arange(0.0, 360.0, 360.0 / 32), grid_lat=np.linspace(-90.0, 90.0, 16),
    input_features_dim=8, output_features_dim=8, noise_dimension=4, hidden_dims=(16, 16),
    num_blocks=2, num_heads=2, splits=2, num_hops=2,
)
CONFIGS = {
    "clustered": dict(BASE, use_edges_features=False, attention_impl="clustered_flash"),
    "segment": dict(BASE, use_edges_features=True, attention_impl="segment"),
}


@cache
def _models(name):
    ref = JaxFGN(**CONFIGS[name])
    params = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    port = FunctionalGenerativeNetwork(**CONFIGS[name], device="cpu")
    port.module.load_state_dict(from_jax_params(params))
    return ref, port, params


def _state(seed, batch=2):
    return np.random.default_rng(seed).normal(size=(batch, 32, 16, 8)).astype(np.float32)


def _noise(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_converted_state_dict_matches_module(name):
    """from_jax_params gives exactly the port module's names and shapes (the
    k-hop edge MLP and edge linears only with edge features)."""
    _, port, params = _models(name)
    expected = {k: tuple(v.shape) for k, v in port.module.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in from_jax_params(params).items()} == expected
    assert ("FGNProcessor_0.GenCastMLP_0.TorchLinear_0.kernel" in expected) == (name == "segment")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_processor_matches_jax(name):
    """FGNProcessor (both block kinds, the noise vector as the condition)
    on the k-hop graph: the clustered branch (the plain K3a) and the
    segment branch with the k-hop edge MLP."""
    ref, port, params = _models(name)
    rng = np.random.default_rng(1)
    latent = rng.normal(size=(2, ref.khop.n_receivers, 16)).astype(np.float32)
    noise = rng.normal(size=(2, 4)).astype(np.float32)
    proc = JaxFGNProcessor(
        latent_dim=16, hidden_dims=(16, 16), num_blocks=2, num_heads=2,
        use_edge_features=CONFIGS[name]["use_edges_features"],
    )
    p = {"params": params["params"]["FGNProcessor_0"]}
    want = jax.jit(lambda x, z: proc.apply(p, x, z, ref.khop))(latent, noise)
    got = port.module.FGNProcessor_0(torch.from_numpy(latent), torch.from_numpy(noise), port.khop)
    _close(got, want, ATOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_member_fn_matches_jax(name):
    ref, port, params = _models(name)
    prev, z = _state(2), _noise(3, (2, 4))
    want = jax.jit(ref.member_fn())(params, prev, z)
    got = port.member_fn()(prev, z)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 16, 8)
    _close(got, want, MODEL_ATOL)


def _jax_draws(key, num_ensemble, batch):
    """The noise vectors the JAX package's forward_fn and
    ensemble_rollout_fn draw from `key`: [E, B, noise_dim]."""
    keys = jax.random.split(key, num_ensemble)
    return np.stack([np.asarray(jax.random.normal(k, (batch, 4))) for k in keys])


@pytest.mark.parametrize("member_chunk", [None, 1])
def test_forward_fn_matches_jax_through_injected_noise(member_chunk):
    """A 4-member ensemble at B = 2: the JAX package's forward_fn (vmapped
    members, or lax.map over chunks of 1) against the port's (members folded
    into the batch, or one at a time) given the same draws."""
    ref, port, params = _models("clustered")
    prev, key = _state(4), jax.random.PRNGKey(5)
    want = jax.jit(ref.forward_fn(4, member_chunk=member_chunk))(params, prev, key)
    got = port.forward_fn(4, member_chunk=member_chunk)(prev, noise=_jax_draws(key, 4, 2))
    assert got.shape == (2, 4, 32, 16, 8)
    _close(got, want, MODEL_ATOL)
    with torch.no_grad():  # apply: every member at once
        served = port.apply(prev, 4, noise=_jax_draws(key, 4, 2))
    assert not served.requires_grad
    _close(served, got.detach().numpy(), 1e-5)


def test_ensemble_rollout_matches_jax_through_injected_noise():
    """2 members, 3 steps, B = 1: each member's noise vector held fixed over
    its steps, the JAX package's scan against the port's loop."""
    ref, port, params = _models("clustered")
    prev, key = _state(6, batch=1), jax.random.PRNGKey(7)
    want = jax.jit(ref.ensemble_rollout_fn(2, 3, member_chunk=1))(params, prev, key)
    fn = port.ensemble_rollout_fn(2, 3, member_chunk=1)
    got = fn(prev, noise=_jax_draws(key, 2, 1))
    assert got.shape == (1, 2, 3, 32, 16, 8)
    _close(got, want, MODEL_ATOL)
    # A member's first step is its forward_fn member.
    first = port.forward_fn(2)(prev, noise=_jax_draws(key, 2, 1))
    _close(got[:, :, 0], first.detach().numpy(), 1e-6)


def _mse(pred, target):
    return ((pred - target) ** 2).mean()


@cache
def _jax_member_step():
    """The JAX package's loss and gradients of bench.py's member objective
    (mean squared error through member_fn), and its gradient norm."""
    ref, _, params = _models("clustered")
    prev, z, target = _state(8), _noise(9, (2, 4)), _state(10)
    member = ref.member_fn()

    def objective(p):
        return jnp.mean((member(p, prev, z) - target) ** 2)

    value, grads = jax.jit(jax.value_and_grad(objective))(params)
    return (prev, z, target), float(value), grads


def test_member_train_step_gradients_match_jax():
    """Loss and every parameter's gradient of a member's MSE against
    jax.value_and_grad through the JAX package's member_fn (the plain K3a
    and K3c here, the Pallas kernels in the interpreter there)."""
    _, port, _ = _models("clustered")
    (prev, z, target), want_loss, want_grads = _jax_member_step()
    port.module.zero_grad(set_to_none=True)
    value = _mse(port.member_fn()(prev, z), torch.from_numpy(target))
    value.backward()
    got = {k: p.grad for k, p in port.module.named_parameters()}
    port.module.zero_grad(set_to_none=True)
    np.testing.assert_allclose(value.item(), want_loss, rtol=1e-5)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, want_grads))
    assert set(got) == set(want)
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for name, g in got.items():
        limit = max(1e-3 * want[name].abs().max().item(), floor)
        assert (g - want[name]).abs().max().item() <= limit, name


def test_train_step_matches_jax():
    """One make_train_step step (bench.py's: MSE, AdamW at lr 1e-4) on the
    member_fn of a fresh model with the same weights: the loss and the
    gradient norm before clipping against the JAX package's (optax.global_norm,
    as its train step reports it); every parameter moves; no kernel launch
    on the CPU."""
    _, reference, _ = _models("clustered")
    (prev, z, target), want_loss, want_grads = _jax_member_step()
    port = FunctionalGenerativeNetwork(**CONFIGS["clustered"], device="cpu")
    port.module.load_state_dict(reference.module.state_dict())
    before = {k: v.clone() for k, v in port.module.state_dict().items()}
    launches = clustered_flash.LAUNCHES, clustered_flash.SYMMETRIC_DQ_LAUNCHES
    step = make_train_step(port.module.parameters(), port.member_fn(), _mse, make_optimizer(1e-4),
                           return_grad_norm=True)
    loss, norm = step(*(torch.from_numpy(a) for a in (prev, z, target)))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(want_grads)), rtol=1e-5)
    after = port.module.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert (clustered_flash.LAUNCHES, clustered_flash.SYMMETRIC_DQ_LAUNCHES) == launches


def test_remat_gives_bit_equal_gradients():
    """remat=True (torch.utils.checkpoint per block) against remat=False on
    the same weights, batch and noise."""
    _, plain, _ = _models("clustered")
    remat = FunctionalGenerativeNetwork(**CONFIGS["clustered"], remat=True, device="cpu")
    remat.module.load_state_dict(plain.module.state_dict())
    prev, z, target = _state(11), _noise(12, (2, 4)), torch.from_numpy(_state(13))
    grads = []
    for model in (plain, remat):
        model.module.zero_grad(set_to_none=True)
        value = _mse(model.member_fn()(prev, z), target)
        value.backward()
        grads.append((value.item(), {k: p.grad for k, p in model.module.named_parameters()}))
        model.module.zero_grad(set_to_none=True)
    assert grads[0][0] == grads[1][0]
    assert all(torch.equal(grads[0][1][k], grads[1][1][k]) for k in grads[0][1])


@pytest.mark.skipif(not GOLDEN.exists(), reason="golden not generated")
def test_member_matches_torch_reference_golden():
    """The fgn_small golden: the reference state_dict through the JAX
    package's convert_fgn, then from_jax_params; its noise through
    member_fn, in the reference's layout quirks."""
    data = np.load(GOLDEN)
    (nlon, nlat, f_in, f_out, zdim, hid, num_blocks, num_heads, splits,
     num_hops, use_edges) = (int(v) for v in data["__config__"])
    port = FunctionalGenerativeNetwork(
        grid_lon=data["__grid_lon__"], grid_lat=data["__grid_lat__"], input_features_dim=f_in,
        output_features_dim=f_out, noise_dimension=zdim, hidden_dims=(hid, hid),
        num_blocks=num_blocks, num_heads=num_heads, splits=splits, num_hops=num_hops,
        use_edges_features=bool(use_edges), mesh_orientation="graphcast",
        node_layout="reference", device="cpu",
    )
    sd = {k: data[k] for k in data.files if not k.startswith("__")}
    params = convert_fgn(sd, num_blocks=num_blocks, mlp_hidden_dims=2,
                         use_edges_features=bool(use_edges))
    port.module.load_state_dict(from_jax_params(params))
    prev = data["__prev__"].reshape(2, nlon, nlat, f_in)
    with torch.no_grad():
        out = port.member_fn()(prev, data["__noise__"]).reshape(2, -1, f_out).numpy()
    per_var_rmse = np.sqrt(((out - data["__output__"]) ** 2).mean(axis=(0, 1)))
    assert per_var_rmse.max() < 1e-5, per_var_rmse


def test_options_and_errors():
    """Banded attention at a head above the card's 512 raises before any
    launch (the last block's heads are the latent width), naming ROADMAP §2
    item 4; bf16 with the banded attention names its queue item; member
    chunks must divide the ensemble; a rollout needs F_out == F_in; the
    noise must be given or drawn; the entry points default to the card."""
    wide = dict(CONFIGS["clustered"], hidden_dims=(1024, 1024), attention_impl="banded_flash")
    with pytest.raises(NotImplementedError, match="§2 item 4"):
        FunctionalGenerativeNetwork(**wide, device="cuda")
    banded = FunctionalGenerativeNetwork(**dict(CONFIGS["clustered"], attention_impl="banded"),
                                         device="cpu")
    with pytest.raises(NotImplementedError, match=BANDED_BF16_TODO):
        banded.member_fn(compute_dtype=torch.bfloat16)
    _, port, _ = _models("clustered")
    with pytest.raises(ValueError, match="must divide"):
        port.forward_fn(4, member_chunk=3)
    with pytest.raises(ValueError, match="torch.Generator"):
        port.forward_fn(2)(_state(14))
    with pytest.raises(ValueError, match="noise_vector"):
        port.member_fn()(_state(14), _noise(15, (2, 5)))
    other = FunctionalGenerativeNetwork(**dict(CONFIGS["clustered"], output_features_dim=3),
                                        device="cpu")
    with pytest.raises(ValueError, match="autoregressive"):
        other.ensemble_rollout_fn(2, 2)
    # Handles of one grid, mesh and attention share their graphs; others not.
    assert other.khop is port.khop and other.graphs is port.graphs
    segment = FunctionalGenerativeNetwork(**CONFIGS["segment"], device="cpu")
    assert segment.khop is not port.khop and segment.khop.cluster_ids is None
    gen = torch.Generator().manual_seed(0)
    drawn = port.forward_fn(2)(_state(16), gen)
    again = port.forward_fn(2)(_state(16), torch.Generator().manual_seed(0))
    assert torch.equal(drawn, again) and not torch.equal(drawn[:, 0], drawn[:, 1])
    assert FunctionalGenerativeNetworkConfig(**CONFIGS["clustered"]).device == "cuda"
    built = FunctionalGenerativeNetworkConfig(**CONFIGS["clustered"], device="cpu").build()
    assert built.device == torch.device("cpu") and built.attention_impl == "clustered_flash"
