"""The port's bf16 compute policy for FGN against the JAX package's, on the
CPU: member_fn(compute_dtype=bfloat16), its loss and gradients, and an
ensemble through injected noise in bf16.

Both packages get the same f32 weights and numpy inputs and noise, at the
sizes of tests/test_torch_fgn.py. FGN's policy is GenCast's but for its
noise vector, which the JAX package casts to bf16 (the denoiser keeps its
noise level f32), so the conditional norms' scale and bias are bf16
products, each rounded. The JAX references are jitted, as the JAX package
runs them.

The rule (tests/test_torch_gencast_bf16.py's): the port's bf16 must be
closer to the JAX package's bf16 than that is to the JAX package's f32,
    RMSE(port bf16 - JAX bf16) <= 0.5 RMSE(JAX bf16 - JAX f32),
on the output and in global norm over all gradients; the loss within 0.5
|JAX loss bf16 - JAX loss f32|, or 1e-4 of the loss where that is larger.
The port in f32 fails it.
"""

from functools import cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.models.fgn import FunctionalGenerativeNetwork as JaxFGN
from graph_weather_tpu_torch import FunctionalGenerativeNetwork, from_jax_params

torch.set_num_threads(1)
BF16 = torch.bfloat16
RULE = 0.5
BASE = dict(
    grid_lon=np.arange(0.0, 360.0, 360.0 / 32), grid_lat=np.linspace(-90.0, 90.0, 16),
    input_features_dim=8, output_features_dim=8, noise_dimension=4, hidden_dims=(16, 16),
    num_blocks=2, num_heads=2, splits=2, num_hops=2,
)
CONFIGS = {
    "clustered": dict(BASE, use_edges_features=False, attention_impl="clustered_flash"),
    "segment": dict(BASE, use_edges_features=True, attention_impl="segment"),
}


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def _global_norm(grads):
    return float(np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2)) for g in grads.values())))


@cache
def _models(name):
    ref = JaxFGN(**CONFIGS[name])
    params = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    port = FunctionalGenerativeNetwork(**CONFIGS[name], device="cpu")
    port.module.load_state_dict(from_jax_params(params))
    return ref, port, params


def _batch(seed):
    rng = np.random.default_rng(seed)
    prev, target = (rng.normal(size=(2, 32, 16, 8)).astype(np.float32) for _ in range(2))
    return prev, rng.normal(size=(2, 4)).astype(np.float32), target


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_member_matches_jax(name):
    """member_fn in bf16 (the clustered branch's plain K3a in bf16; the
    segment branch's sums on S) against the JAX package's bf16 member."""
    ref, port, params = _models(name)
    prev, z, _ = _batch(1)
    want = np.asarray(jax.jit(ref.member_fn(compute_dtype=jnp.bfloat16))(params, prev, z))
    base = np.asarray(jax.jit(ref.member_fn())(params, prev, z))
    with torch.no_grad():
        got = port.member_fn(compute_dtype=BF16)(prev, z)
    assert got.dtype == torch.float32 and got.shape == prev.shape
    assert _rmse(got.numpy(), want) <= RULE * _rmse(want, base)


@cache
def _jax_losses():
    """The JAX package's MSE and gradients through member_fn, in f32 and in
    bf16 (the f32 masters' gradients)."""
    ref, _, params = _models("clustered")
    prev, z, target = _batch(2)
    runs = {}
    for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        member = ref.member_fn(compute_dtype=dtype)

        def objective(p, member=member):
            return jnp.mean((member(p, prev, z) - target) ** 2)

        value, grads = jax.jit(jax.value_and_grad(objective))(params)
        runs[name] = (float(value), {
            k: v.numpy() for k, v in from_jax_params(jax.tree_util.tree_map(np.asarray, grads)).items()
        })
    return (prev, z, target), runs


def test_bf16_loss_and_gradients_match_jax():
    """The member's MSE and the f32 parameters' gradients through the bf16
    copies (one flat cast) against jax.value_and_grad of the JAX package's
    bf16 member_fn."""
    _, port, _ = _models("clustered")
    (prev, z, target), runs = _jax_losses()
    port.module.zero_grad(set_to_none=True)
    pred = port.member_fn(compute_dtype=BF16)(prev, z)
    value = ((pred - torch.from_numpy(target)) ** 2).mean()
    value.backward()
    got = {k: p.grad.numpy() for k, p in port.module.named_parameters()}
    port.module.zero_grad(set_to_none=True)
    assert all(p.dtype == torch.float32 for p in port.module.parameters())
    (want_loss, want), (base_loss, base) = runs["bf16"], runs["f32"]
    assert abs(value.item() - want_loss) <= max(RULE * abs(want_loss - base_loss), 1e-4 * want_loss)
    diff = _global_norm({k: got[k] - want[k] for k in want})
    assert diff <= RULE * _global_norm({k: want[k] - base[k] for k in want})


def test_bf16_ensemble_matches_jax_through_injected_noise():
    """A 2-member bf16 ensemble, one member at a time (bench.py's
    member_chunk=1), against the JAX package's bf16 forward_fn given its
    own draws."""
    ref, port, params = _models("clustered")
    prev, key = _batch(3)[0], jax.random.PRNGKey(4)
    keys = jax.random.split(key, 2)
    draws = np.stack([np.asarray(jax.random.normal(k, (2, 4))) for k in keys])
    fwd = ref.forward_fn(2, compute_dtype=jnp.bfloat16, member_chunk=1)
    want = np.asarray(jax.jit(fwd)(params, prev, key))
    base = np.asarray(jax.jit(ref.forward_fn(2, member_chunk=1))(params, prev, key))
    with torch.no_grad():
        got = port.forward_fn(2, compute_dtype=BF16, member_chunk=1)(prev, noise=draws)
    assert got.shape == (2, 2, 32, 16, 8)
    assert _rmse(got.numpy(), want) <= RULE * _rmse(want, base)

