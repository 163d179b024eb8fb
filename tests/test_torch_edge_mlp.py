"""The port's fused edge MLP (K1) against the JAX package's Pallas kernel.

On CPU tensors the port's `fused_edge_mlp` runs its plain PyTorch version;
the JAX `fused_edge_mlp` runs its Pallas kernel in interpret mode, set here
as tests/test_pallas_kernels.py sets it. Same numpy inputs, atol 2e-5 (f32,
LayerNorm'd O(1) outputs; only the summation order differs).

The CUDA kernel itself runs only on a GPU: tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import graph_weather_tpu.ops.pallas.edge_mlp as jax_edge_mlp
from graph_weather_tpu_torch.ops import edge_mlp

torch.set_num_threads(1)
ATOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jax_edge_mlp.pl, "pallas_call", interp)
    jax_edge_mlp._fused_edge_mlp_padded.clear_cache()
    yield
    jax_edge_mlp._fused_edge_mlp_padded.clear_cache()


def _params(rng, f_src, f_dst, f_e, hidden):
    def a(*shape, scale=0.05):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {
        "TorchLinear_0": {"kernel": a(f_src + f_dst + f_e, hidden), "bias": a(hidden, scale=0.1)},
        "TorchLinear_1": {"kernel": a(hidden, hidden), "bias": a(hidden, scale=0.1)},
        "TorchLinear_2": {"kernel": a(hidden, f_e), "bias": a(f_e, scale=0.1)},
        "LayerNorm_0": {"scale": 1.0 + a(f_e, scale=0.1), "bias": a(f_e, scale=0.1)},
    }


def _weights(p):
    t = torch.from_numpy
    return dict(
        w0=t(p["TorchLinear_0"]["kernel"]), b0=t(p["TorchLinear_0"]["bias"]),
        w1=t(p["TorchLinear_1"]["kernel"]), b1=t(p["TorchLinear_1"]["bias"]),
        w2=t(p["TorchLinear_2"]["kernel"]), b2=t(p["TorchLinear_2"]["bias"]),
        gamma=t(p["LayerNorm_0"]["scale"]), beta=t(p["LayerNorm_0"]["bias"]),
    )


def _graph(rng, n_src, n_dst, n_edges):
    senders = rng.integers(0, n_src, n_edges).astype(np.int32)
    receivers = np.sort(rng.integers(0, n_dst, n_edges)).astype(np.int32)
    return senders, receivers


def _jax(senders, receivers, xs, xd, e, p, tile=128):
    return np.asarray(
        jax_edge_mlp.fused_edge_mlp(
            jnp.asarray(senders), jnp.asarray(receivers), jnp.asarray(xs),
            jnp.asarray(xd), jnp.asarray(e), p, tile=tile,
        )
    )


def _port(senders, receivers, xs, xd, e, p):
    out = edge_mlp.fused_edge_mlp(
        torch.from_numpy(senders), torch.from_numpy(receivers),
        torch.from_numpy(xs), None if xd is None else torch.from_numpy(xd),
        torch.from_numpy(e), **_weights(p),
    )
    return out.numpy()


@pytest.mark.parametrize(
    "case",
    [
        # (seed, n_src, n_dst, n_edges, F, Fe, H): homogeneous, tile multiple
        (0, 64, 64, 512, 32, 32, 32),
        # bipartite node sets, narrow and unequal widths
        (1, 40, 70, 256, 16, 24, 48),
        # an edge count that is not a tile multiple
        (2, 50, 30, 333, 32, 32, 32),
    ],
    ids=["homogeneous", "bipartite", "ragged_tail"],
)
def test_matches_pallas_kernel(case):
    seed, n_src, n_dst, n_edges, f, f_e, hidden = case
    rng = np.random.default_rng(seed)
    senders, receivers = _graph(rng, n_src, n_dst, n_edges)
    xs = rng.normal(size=(n_src, f)).astype(np.float32)
    xd = rng.normal(size=(n_dst, f)).astype(np.float32)
    e = rng.normal(size=(n_edges, f_e)).astype(np.float32)
    p = _params(rng, f, f, f_e, hidden)
    out = _port(senders, receivers, xs, xd, e, p)
    assert out.shape == (n_edges, f_e)
    np.testing.assert_allclose(out, _jax(senders, receivers, xs, xd, e, p), atol=ATOL)


@pytest.mark.parametrize("e_batched", [True, False], ids=["batched_e", "broadcast_e"])
def test_batched_nodes_match_per_sample_kernel(e_batched):
    """[B, N, F] nodes with [B, E, Fe] or batch-broadcast [E, Fe] edges
    against the unbatched Pallas kernel run once per sample."""
    rng = np.random.default_rng(7)
    b, n_src, n_dst, n_edges, f = 3, 48, 20, 200, 16
    senders, receivers = _graph(rng, n_src, n_dst, n_edges)
    xs = rng.normal(size=(b, n_src, f)).astype(np.float32)
    xd = rng.normal(size=(b, n_dst, f)).astype(np.float32)
    e = rng.normal(size=(b, n_edges, f) if e_batched else (n_edges, f)).astype(np.float32)
    p = _params(rng, f, f, f, f)
    out = _port(senders, receivers, xs, xd, e, p)
    assert out.shape == (b, n_edges, f)
    for i in range(b):
        ref = _jax(senders, receivers, xs[i], xd[i], e[i] if e_batched else e, p)
        np.testing.assert_allclose(out[i], ref, atol=ATOL)


def test_broadcast_destination_nodes():
    """x_dst as an expand()ed [B, N, F] view (the encoder's mesh seeds)."""
    rng = np.random.default_rng(8)
    senders, receivers = _graph(rng, 30, 12, 90)
    xs = rng.normal(size=(2, 30, 16)).astype(np.float32)
    xd = rng.normal(size=(12, 16)).astype(np.float32)
    e = rng.normal(size=(90, 16)).astype(np.float32)
    p = _params(rng, 16, 16, 16, 16)
    out = edge_mlp.fused_edge_mlp(
        torch.from_numpy(senders), torch.from_numpy(receivers),
        torch.from_numpy(xs), torch.from_numpy(xd).expand(2, 12, 16),
        torch.from_numpy(e), **_weights(p),
    )
    for i in range(2):
        np.testing.assert_allclose(
            out[i].numpy(), _jax(senders, receivers, xs[i], xd, e, p), atol=ATOL
        )


def test_zero_destination_matches_kernel_with_zeros():
    """x_dst=None (dst_is_zero) equals the Pallas kernel given zero x_dst."""
    rng = np.random.default_rng(9)
    senders, receivers = _graph(rng, 25, 80, 300)
    xs = rng.normal(size=(25, 32)).astype(np.float32)
    e = rng.normal(size=(300, 32)).astype(np.float32)
    p = _params(rng, 32, 32, 32, 32)
    out = _port(senders, receivers, xs, None, e, p)
    zeros = np.zeros((80, 32), np.float32)
    np.testing.assert_allclose(out, _jax(senders, receivers, xs, zeros, e, p), atol=ATOL)


def test_without_layer_norm():
    """gamma=beta=None drops the LayerNorm (norm_type=None); the Pallas
    kernel always normalizes, so compare against the formula written out."""
    rng = np.random.default_rng(10)
    senders, receivers = _graph(rng, 20, 20, 64)
    x = torch.from_numpy(rng.normal(size=(20, 8)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    w = _weights(_params(rng, 8, 8, 8, 12))
    s, r = torch.from_numpy(senders), torch.from_numpy(receivers)
    out = edge_mlp.fused_edge_mlp(s, r, x, x, e, **{**w, "gamma": None, "beta": None})
    inp = torch.cat([x[s.long()], x[r.long()], e], dim=-1)
    h = torch.relu(inp @ w["w0"] + w["b0"])
    h = torch.relu(h @ w["w1"] + w["b1"])
    np.testing.assert_allclose(out.numpy(), (h @ w["w2"] + w["b2"] + e).numpy(), atol=ATOL)


def _valid_args():
    rng = np.random.default_rng(11)
    senders, receivers = _graph(rng, 10, 10, 40)
    args = dict(
        senders=torch.from_numpy(senders),
        receivers=torch.from_numpy(receivers),
        x_src=torch.randn(10, 8),
        x_dst=torch.randn(10, 8),
        e=torch.randn(40, 8),
    )
    args.update(_weights(_params(rng, 8, 8, 8, 8)))
    return args


@pytest.mark.parametrize(
    "bad, error",
    [
        (dict(senders=torch.zeros(40, dtype=torch.int64)), TypeError),
        (dict(x_src=torch.randn(10, 8, dtype=torch.float64)), TypeError),
        (dict(e=torch.randn(39, 8)), ValueError),
        (dict(x_dst=torch.randn(10, 6)), ValueError),
        (dict(w1=torch.randn(8, 9)), ValueError),
        (
            dict(
                w0=torch.randn(24, 300), b0=torch.randn(300),
                w1=torch.randn(300, 300), b1=torch.randn(300), w2=torch.randn(300, 8),
            ),
            ValueError,
        ),
        (dict(gamma=None), ValueError),
        (dict(x_src=torch.randn(8, 10).t()), ValueError),
        (dict(e=torch.randn(2, 40, 8)), ValueError),
    ],
    ids=[
        "int64_indices", "float64_nodes", "edge_count", "dst_width",
        "w1_shape", "too_wide", "gamma_without_beta", "column_major",
        "batched_e_unbatched_nodes",
    ],
)
def test_wrapper_rejects_bad_inputs(bad, error):
    args = _valid_args()
    edge_mlp.fused_edge_mlp(**args)  # the valid call passes
    args.update(bad)
    with pytest.raises(error):
        edge_mlp.fused_edge_mlp(**args)


def test_cpu_path_does_not_count_launches():
    before = edge_mlp.LAUNCHES
    edge_mlp.fused_edge_mlp(**_valid_args())
    assert edge_mlp.LAUNCHES == before
