"""The port's bf16 compute policy for GenCast against the JAX package's, on
the CPU: Denoiser.forward_fn(compute_dtype=bfloat16), its loss and
gradients, Sampler.sample_injected and the AR rollout in bf16.

Both packages get the same f32 weights (a flax tree -> convert.from_jax_params)
and the same numpy inputs. The configs are the clustered test config of
tests/test_torch_gencast.py with 8 output channels (at 2 the decoder's final
LayerNorm amplifies every difference) and a segment config with k-hop edge
features at the same widths. The JAX references are jitted, as the JAX
package runs them.

The rule: the port's bf16 must be closer to the JAX package's bf16 than
that is to the JAX package's f32,
    RMSE(port bf16 - JAX bf16) <= 0.5 RMSE(JAX bf16 - JAX f32),
on the output, in global norm over all gradients, and on a 3-step sample;
the loss within 0.5 |JAX loss bf16 - JAX loss f32|, or 1e-4 of the loss
where that is larger (a chance cancellation between the two losses must not
make the limit near zero). A port that ran in f32 fails it, and so does
one that rounds at other points than the JAX package does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.models.gencast import Denoiser as JaxDenoiser
from graph_weather_tpu.models.gencast import Sampler as JaxSampler
from graph_weather_tpu_torch import (
    Denoiser,
    Sampler,
    from_jax_params,
    make_ar_rollout_fn,
    make_optimizer,
    make_train_step,
)
from graph_weather_tpu_torch.models.gencast import modules
from graph_weather_tpu_torch.models.gencast.denoiser import BANDED_BF16_TODO
from graph_weather_tpu_torch.models.gencast.rollout import default_update_fn

torch.set_num_threads(1)
BF16 = torch.bfloat16
RULE = 0.5
BASE = dict(
    grid_lon=np.arange(0.0, 360.0, 360.0 / 32), grid_lat=np.linspace(-90.0, 90.0, 16),
    input_features_dim=3, output_features_dim=8, hidden_dims=(16, 16), num_blocks=2,
    num_heads=2, splits=2, num_hops=2,
)
CONFIGS = {
    "clustered": dict(BASE, use_edges_features=False, attention_impl="clustered_flash"),
    "segment": dict(BASE, use_edges_features=True, attention_impl="segment"),
}


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    corrupted = rng.normal(size=(2, 32, 16, 8)).astype(np.float32)
    prev = rng.normal(size=(2, 32, 16, 6)).astype(np.float32)
    target = rng.normal(size=(2, 32, 16, 8)).astype(np.float32)
    return corrupted, prev, np.array([[0.7], [3.0]], np.float32), target


def _models(name):
    ref = JaxDenoiser(**CONFIGS[name])
    params = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    port = Denoiser(**CONFIGS[name], device="cpu")
    port.module.load_state_dict(from_jax_params(params))
    return ref, port, params


@pytest.fixture(scope="module")
def clustered():
    """The clustered config in both packages, with the JAX package's f32
    and bf16 outputs and value_and_grad of the mean squared error."""
    ref, port, params = _models("clustered")
    corrupted, prev, sigma, target = _inputs()
    jax_runs = {}
    for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        fn = ref.forward_fn(compute_dtype=dtype)

        def loss(p, fn=fn):
            pred = fn(p, corrupted, prev, sigma)
            return jnp.mean((pred - target) ** 2), pred

        (value, pred), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        jax_runs[name] = (np.asarray(pred), value, grads)
    return ref, port, params, (corrupted, prev, sigma, target), jax_runs


def _grads(tree):
    return {k: np.asarray(v) for k, v in from_jax_params(jax.tree_util.tree_map(np.asarray, tree)).items()}


def _global_norm(grads):
    return float(np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2)) for g in grads.values())))


def test_bf16_output_matches_jax_clustered(clustered):
    _, port, _, (corrupted, prev, sigma, _), runs = clustered
    got = port.forward_fn(compute_dtype=BF16)(corrupted, prev, sigma)
    assert got.dtype == torch.float32 and got.shape == corrupted.shape
    assert bool(torch.isfinite(got).all())
    want, base = runs["bf16"][0], runs["f32"][0]
    assert _rmse(got.detach().numpy(), want) <= RULE * _rmse(want, base)


def test_bf16_output_matches_jax_segment():
    """The segment-softmax branch with k-hop edge features, bf16 through
    its segment sums."""
    ref, port, params = _models("segment")
    corrupted, prev, sigma, _ = _inputs(1)
    want = np.asarray(jax.jit(ref.forward_fn(compute_dtype=jnp.bfloat16))(params, corrupted, prev, sigma))
    base = np.asarray(jax.jit(ref.forward_fn())(params, corrupted, prev, sigma))
    got = port.forward_fn(compute_dtype=BF16)(corrupted, prev, sigma)
    assert got.dtype == torch.float32
    assert _rmse(got.detach().numpy(), want) <= RULE * _rmse(want, base)


def test_bf16_loss_and_gradients_match_jax(clustered):
    """value_and_grad of the mean squared error through the bf16 policy:
    the loss, and every gradient in global norm, against the JAX package's;
    the gradients reach the f32 parameters in f32."""
    _, port, _, (corrupted, prev, sigma, target), runs = clustered
    port.module.zero_grad(set_to_none=True)
    pred = port.forward_fn(compute_dtype=BF16)(corrupted, prev, sigma)
    loss = torch.mean((pred - torch.from_numpy(target)) ** 2)
    loss.backward()
    got = {k: p.grad.numpy() for k, p in port.module.named_parameters()}
    assert all(p.grad.dtype == torch.float32 for p in port.module.parameters())
    (_, loss16, grads16), (_, loss32, grads32) = runs["bf16"], runs["f32"]
    loss16, loss32 = float(loss16), float(loss32)
    assert abs(loss.item() - loss16) <= max(RULE * abs(loss16 - loss32), 1e-4 * abs(loss16))
    want, base = _grads(grads16), _grads(grads32)
    assert got.keys() == want.keys()
    diff = _global_norm({k: got[k] - want[k] for k in want})
    assert diff <= RULE * _global_norm({k: want[k] - base[k] for k in want})


def test_bf16_attention_runs_on_bf16(clustered, monkeypatch):
    """The clustered attention gets bf16 q, k and v; the parameters stay
    f32 masters; the f32 forward_fn is the f32 path (f32 q, k, v)."""
    _, port, _, (corrupted, prev, sigma, _), _ = clustered
    seen = []

    def spy(q, k, v, *args, **kwargs):
        seen.append((q.dtype, k.dtype, v.dtype))
        return attention(q, k, v, *args, **kwargs)

    attention = modules.clustered_flash_attention
    monkeypatch.setattr(modules, "clustered_flash_attention", spy)
    with torch.no_grad():
        out = port.forward_fn(compute_dtype=BF16)(corrupted, prev, sigma)
        assert seen and set(seen) == {(BF16,) * 3}
        seen.clear()
        port.forward_fn()(corrupted, prev, sigma)
    assert seen and set(seen) == {(torch.float32,) * 3}
    assert out.dtype == torch.float32
    assert {p.dtype for p in port.module.parameters()} == {torch.float32}


def test_bf16_remat_repeats_gradients():
    """remat recomputes each block on the bf16 copies the forward used:
    the gradients equal those without remat, bit for bit."""
    corrupted, prev, sigma, target = _inputs(2)
    grads = []
    for remat in (False, True):
        den = Denoiser(**CONFIGS["clustered"], remat=remat, device="cpu")
        den.init(torch.Generator().manual_seed(0))
        pred = den.forward_fn(compute_dtype=BF16)(corrupted, prev, sigma)
        torch.mean((pred - torch.from_numpy(target)) ** 2).backward()
        grads.append([p.grad for p in den.module.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_bf16_sample_injected_matches_jax(clustered):
    """A 3-step injected-noise sample with bf16 denoiser evaluations
    against the JAX package's sample_fn_injected(compute_dtype=bfloat16)."""
    ref, port, params, (_, prev, _, _), _ = clustered
    rng = np.random.default_rng(5)
    init = rng.normal(size=(2, 32, 16, 8)).astype(np.float32)
    churn = rng.normal(size=(2, 2, 32, 16, 8)).astype(np.float32)
    sampler = JaxSampler(num_steps=3)
    want = np.asarray(jax.jit(sampler.sample_fn_injected(ref, compute_dtype=jnp.bfloat16))(
        params, prev, init, churn))
    base = np.asarray(jax.jit(sampler.sample_fn_injected(ref))(params, prev, init, churn))
    got = Sampler(num_steps=3, device="cpu").sample_injected(
        port, prev, init, churn, compute_dtype=BF16
    )
    assert got.dtype == torch.float32 and got.shape == init.shape
    assert _rmse(got.numpy(), want) <= RULE * _rmse(want, base)


def test_bf16_rollout_and_sample(clustered):
    """A 2-step AR rollout and a key-driven sample in bf16: finite, f32, the
    shapes of the f32 ones."""
    _, port, _, (_, prev, _, _), _ = clustered
    sampler = Sampler(num_steps=3, device="cpu")
    update = lambda prev, sample: default_update_fn(prev, sample[..., :3])  # noqa: E731 (3 inputs)
    rollout = make_ar_rollout_fn(sampler, port, 2, compute_dtype=BF16, update_fn=update, device="cpu")
    traj = rollout(prev, torch.Generator().manual_seed(0))
    assert traj.shape == (2, 2, 32, 16, 8) and traj.dtype == torch.float32
    assert bool(torch.isfinite(traj).all())
    one = sampler.sample(port, prev, torch.Generator().manual_seed(1), compute_dtype=BF16)
    assert one.shape == (2, 32, 16, 8) and one.dtype == torch.float32
    assert bool(torch.isfinite(one).all())


def test_bf16_train_step_keeps_f32_parameters():
    """make_train_step over a bf16 forward_fn (bench.py's gencast_train
    objective: mean squared error, make_optimizer(1e-4)): the parameters,
    their gradients and the optimizer's moments stay f32, and they move."""
    den = Denoiser(**CONFIGS["clustered"], device="cpu")
    den.init(torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in den.module.parameters()]
    corrupted, prev, sigma, target = _inputs(3)
    step = make_train_step(
        den.module.parameters(), den.forward_fn(compute_dtype=BF16),
        lambda pred, tgt: torch.mean((pred - tgt) ** 2), make_optimizer(1e-4),
    )
    loss = step(corrupted, prev, sigma, torch.from_numpy(target))
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    params = list(den.module.parameters())
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in params)
    moments = [t for s in step.optimizer.state.values() for t in s.values()
               if isinstance(t, torch.Tensor) and t.is_floating_point()]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    assert any(not torch.equal(a, b) for a, b in zip(before, params))


@pytest.mark.parametrize("impl", ["banded", "banded_flash"])
def test_bf16_on_banded_attention_raises(impl):
    """The banded options have no bf16 mode yet: forward_fn(bfloat16)
    raises and names the ROADMAP item; their f32 forward_fn is there."""
    den = Denoiser(**dict(CONFIGS["clustered"], attention_impl=impl), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as info:
        den.forward_fn(compute_dtype=BF16)
    assert BANDED_BF16_TODO in str(info.value)
    assert den.forward_fn() is not None


def test_other_compute_dtypes_raise(clustered):
    _, port, *_ = clustered
    with pytest.raises(NotImplementedError, match="float16"):
        port.forward_fn(compute_dtype=torch.float16)
