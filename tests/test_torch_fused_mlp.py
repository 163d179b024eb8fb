"""The port's fused edge update (K2, and its backward) against the JAX package.

On CPU tensors the port's `fused_edge_update` runs its plain PyTorch
versions; the JAX `fused_edge_update` (graph_weather_tpu/ops/pallas/
fused_mlp.py) runs its Pallas kernel in interpret mode, set here as
tests/test_torch_edge_mlp.py sets it, on partials that numpy gathers per
edge. The backward is held against jax.vjp of the JAX package's EdgeBlock
(the XLA path its forecaster trains through) and against float64 autograd
of the plain forward. Tolerances: atol 2e-5 on the forward (f32, LayerNorm'd
O(1) outputs; only the summation order differs); each gradient within 2e-5
of its tensor's max|g| against JAX (sums over up to ~100 edges in another
order); 1e-10 in float64.

The CUDA kernels themselves run only on a GPU: tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import graph_weather_tpu.ops.pallas.fused_mlp as jax_fused_mlp
from graph_weather_tpu.meshes.graphs import GraphBundle as JaxBundle
from graph_weather_tpu.nn import graph_blocks as jax_blocks
from graph_weather_tpu_torch.meshes.graphs import GraphBundle
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph, EdgeBlock
from graph_weather_tpu_torch.ops import fused_mlp
from graph_weather_tpu_torch.ops.scatter import build_chunked_csr, chunked_csr_agg

torch.set_num_threads(1)
ATOL = 2e-5
GRAD_RTOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jax_fused_mlp.pl, "pallas_call", interp)
    jax_fused_mlp._fused_padded.clear_cache()
    yield
    jax_fused_mlp._fused_padded.clear_cache()


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _params(rng, f_e, hidden, k0=None):
    """The edge MLP tree; TorchLinear_0's kernel is [k0, H] with We its last
    f_e rows (k0 = f_e: We alone)."""
    k0 = f_e if k0 is None else k0
    return {
        "TorchLinear_0": {"kernel": _rand(rng, k0, hidden, scale=k0**-0.5),
                          "bias": _rand(rng, hidden, scale=0.1)},
        "TorchLinear_1": {"kernel": _rand(rng, hidden, hidden, scale=hidden**-0.5),
                          "bias": _rand(rng, hidden, scale=0.1)},
        "TorchLinear_2": {"kernel": _rand(rng, hidden, f_e, scale=hidden**-0.5),
                          "bias": _rand(rng, f_e, scale=0.1)},
        "LayerNorm_0": {"scale": 1.0 + _rand(rng, f_e, scale=0.1),
                        "bias": _rand(rng, f_e, scale=0.1)},
    }


def _weights(p, norm=True):
    """The port's (we, b0, w1, b1, w2, b2, gamma, beta) from the tree."""
    t = torch.from_numpy
    f_e = p["TorchLinear_2"]["kernel"].shape[1]
    return (
        t(p["TorchLinear_0"]["kernel"][-f_e:].copy()), t(p["TorchLinear_0"]["bias"]),
        t(p["TorchLinear_1"]["kernel"]), t(p["TorchLinear_1"]["bias"]),
        t(p["TorchLinear_2"]["kernel"]), t(p["TorchLinear_2"]["bias"]),
        t(p["LayerNorm_0"]["scale"]) if norm else None,
        t(p["LayerNorm_0"]["bias"]) if norm else None,
    )


def _graph(rng, n_src, n_dst, n_edges):
    senders = rng.integers(0, n_src, n_edges).astype(np.int32)
    receivers = np.sort(rng.integers(0, n_dst, n_edges)).astype(np.int32)
    return senders, receivers


def _tables(senders, receivers, n_src, n_dst, chunk=16):
    """The node-sum tables of both sides (ops.scatter.build_chunked_csr)."""
    def levels(ids, n):
        return tuple(tuple(map(torch.from_numpy, t)) for t in build_chunked_csr(ids, n, chunk))

    return dict(sender_sum=levels(senders, n_src), receiver_sum=levels(receivers, n_dst))


def _jax_k2(xs, xd, e, p, tile=128):
    """The Pallas K2 on per-edge partials (numpy-gathered)."""
    out = jax_fused_mlp.fused_edge_update(jnp.asarray(xs), jnp.asarray(xd), jnp.asarray(e), p, tile=tile)
    return np.asarray(out)


def _port(senders, receivers, p_src, p_dst, e, p, norm=True):
    t = torch.from_numpy
    n_dst = int(receivers.max()) + 1 if p_dst is None else p_dst.shape[-2]
    out = fused_mlp.fused_edge_update(
        t(senders), t(receivers), t(p_src), None if p_dst is None else t(p_dst), t(e),
        *_weights(p, norm), **_tables(senders, receivers, p_src.shape[-2], n_dst),
    )
    return out.numpy()


@pytest.mark.parametrize(
    "case",
    [
        # (seed, n_src, n_dst, n_edges, Fe, H, gathered)
        (0, 0, 0, 512, 32, 48, False),  # senders = receivers = arange(E)
        (1, 40, 70, 256, 24, 48, True),  # a bipartite graph, gathers in numpy
        (2, 50, 30, 333, 32, 32, True),  # an edge count that is not a tile multiple
    ],
    ids=["identity", "gathered", "ragged_tail"],
)
def test_matches_pallas_kernel(case):
    seed, n_src, n_dst, n_edges, f_e, hidden, gathered = case
    rng = np.random.default_rng(seed)
    if gathered:
        senders, receivers = _graph(rng, n_src, n_dst, n_edges)
    else:
        senders = receivers = np.arange(n_edges, dtype=np.int32)
        n_src = n_dst = n_edges
    p_src, p_dst = _rand(rng, n_src, hidden), _rand(rng, n_dst, hidden)
    e = _rand(rng, n_edges, f_e)
    p = _params(rng, f_e, hidden)
    out = _port(senders, receivers, p_src, p_dst, e, p)
    assert out.shape == (n_edges, f_e)
    np.testing.assert_allclose(out, _jax_k2(p_src[senders], p_dst[receivers], e, p), atol=ATOL)


@pytest.mark.parametrize("layout", ["batched_e", "broadcast_e", "broadcast_dst"])
def test_batched_and_broadcast_operands(layout):
    """B = 2: [B, E, Fe] or batch-broadcast [E, Fe] edges, and an unbatched
    p_dst beside a batched p_src (the encoder's mesh seeds), against the
    Pallas kernel run once per sample."""
    rng = np.random.default_rng(7)
    b, n_src, n_dst, n_edges, f_e, hidden = 2, 48, 20, 200, 16, 24
    senders, receivers = _graph(rng, n_src, n_dst, n_edges)
    p_src = _rand(rng, b, n_src, hidden)
    p_dst = _rand(rng, n_dst, hidden) if layout == "broadcast_dst" else _rand(rng, b, n_dst, hidden)
    e = _rand(rng, b, n_edges, f_e) if layout == "batched_e" else _rand(rng, n_edges, f_e)
    p = _params(rng, f_e, hidden)
    out = _port(senders, receivers, p_src, p_dst, e, p)
    assert out.shape == (b, n_edges, f_e)
    for i in range(b):
        xd = (p_dst if p_dst.ndim == 2 else p_dst[i])[receivers]
        want = _jax_k2(p_src[i][senders], xd, e[i] if e.ndim == 3 else e, p)
        np.testing.assert_allclose(out[i], want, atol=ATOL)


def test_zero_destination_matches_kernel_with_zeros():
    """p_dst=None (dst_is_zero) equals the Pallas kernel given zero partials."""
    rng = np.random.default_rng(9)
    senders, receivers = _graph(rng, 25, 80, 300)
    p_src, e = _rand(rng, 25, 32), _rand(rng, 300, 16)
    p = _params(rng, 16, 32)
    out = _port(senders, receivers, p_src, None, e, p)
    zeros = np.zeros((300, 32), np.float32)
    np.testing.assert_allclose(out, _jax_k2(p_src[senders], zeros, e, p), atol=ATOL)


def test_without_layer_norm():
    """gamma=beta=None drops the LayerNorm; the Pallas kernel always
    normalizes, so compare against the formula written out."""
    rng = np.random.default_rng(10)
    senders, receivers = _graph(rng, 20, 20, 64)
    p_src, p_dst, e = _rand(rng, 20, 12), _rand(rng, 20, 12), _rand(rng, 64, 8)
    p = _params(rng, 8, 12)
    out = _port(senders, receivers, p_src, p_dst, e, p, norm=False)
    we, b0, w1, b1, w2, b2, _, _ = (t.numpy() if t is not None else None for t in _weights(p))
    h = np.maximum(p_src[senders] + p_dst[receivers] + e @ we + b0, 0)
    h = np.maximum(h @ w1 + b1, 0)
    np.testing.assert_allclose(out, h @ w2 + b2 + e, atol=ATOL)


def _bundles(senders, receivers, n_src, n_dst):
    attr = np.zeros((senders.shape[0], 2), np.float32)
    return (
        GraphBundle(senders, receivers, attr, n_src, n_dst),
        JaxBundle(senders, receivers, attr, n_src, n_dst),
    )


def _port_edge_block(p, f, f_e, hidden, dst_is_zero):
    block = EdgeBlock(f, f, f_e, hidden, dst_is_zero=dst_is_zero)
    sd = {
        f"MLP_0.TorchLinear_{i}.{k}": torch.from_numpy(p[f"TorchLinear_{i}"][k])
        for i in range(3) for k in ("kernel", "bias")
    }
    sd["MLP_0.LayerNorm_0.weight"] = torch.from_numpy(p["LayerNorm_0"]["scale"])
    sd["MLP_0.LayerNorm_0.bias"] = torch.from_numpy(p["LayerNorm_0"]["bias"])
    block.load_state_dict(sd)
    return block


def _assert_close_to_max(got, want, name):
    want = np.asarray(want)
    limit = GRAD_RTOL * max(np.abs(want).max(), 1e-30)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= limit, f"{name}: {err} > {limit}"


@pytest.mark.parametrize(
    "case",
    [
        # (seed, batch, n_src, n_dst, n_edges, broadcast e, dst_is_zero)
        (0, 2, 30, 30, 150, False, False),  # degrees <= 16: one padded CSR table a side
        (1, 2, 12, 10, 300, True, False),  # degrees > 16: two levels of tables a side
        (2, 1, 40, 90, 333, True, True),  # the decoder's dst_is_zero (one table a side)
    ],
    ids=["csr", "chunked_csr", "zero_dst"],
)
def test_backward_matches_jax_edge_block(case):
    """The port's EdgeBlock (x @ Ws, x @ Wd, then fused_edge_update, whose
    CPU backward is fused_edge_update_backward_reference) against jax.vjp of
    the JAX package's EdgeBlock on the same graph, weights, inputs and
    cotangent: the gradients of x_src, x_dst, e and every parameter."""
    seed, b, n_src, n_dst, n_edges, broadcast_e, dst_is_zero = case
    f, f_e, hidden = 12, 10, 16
    rng = np.random.default_rng(seed)
    senders, receivers = _graph(rng, n_src, n_dst, n_edges)
    bundle, jax_bundle = _bundles(senders, receivers, n_src, n_dst)
    graph = DeviceGraph.from_bundle(bundle, "cpu", edge_sums=True)
    jax_graph = jax_blocks.DeviceGraph.from_bundle(jax_bundle)
    levels = 1 if seed != 1 else 2  # the chunked case has degrees above 16
    assert len(graph.sender_sum) == len(graph.receiver_sum) == levels
    if levels == 1:  # the receivers' one table is the forward's CSR table
        assert graph.receiver_sum[0][0] is graph.csr_edge_ids
    # Only graphs built for the edge update's backward carry the tables.
    assert DeviceGraph.from_bundle(bundle, "cpu").sender_sum is None
    p = _params(rng, f_e, hidden, k0=2 * f + f_e)
    x_src, x_dst = _rand(rng, b, n_src, f), _rand(rng, b, n_dst, f)
    e = _rand(rng, n_edges, f_e) if broadcast_e else _rand(rng, b, n_edges, f_e)
    dout = _rand(rng, b, n_edges, f_e)

    jax_block = jax_blocks.EdgeBlock(f_e, hidden, dst_is_zero=dst_is_zero)

    def run(params, xs, xd, ee):
        return jax_block.apply({"params": {"MLP_0": params}}, xs, xd, jnp.broadcast_to(ee, dout.shape), jax_graph)

    out, vjp = jax.vjp(jax.jit(run), p, x_src, x_dst, e)
    d_params, d_src, d_dst, d_e = vjp(jnp.asarray(dout))

    block = _port_edge_block(p, f, f_e, hidden, dst_is_zero)
    xs_t, xd_t, e_t = (torch.from_numpy(a).requires_grad_(True) for a in (x_src, x_dst, e))
    got = block(xs_t, None if dst_is_zero else xd_t, e_t, graph)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=ATOL)
    got.backward(torch.from_numpy(dout))
    _assert_close_to_max(xs_t.grad, d_src, "x_src")
    _assert_close_to_max(e_t.grad, d_e, "e")
    if dst_is_zero:
        assert xd_t.grad is None
    else:
        _assert_close_to_max(xd_t.grad, d_dst, "x_dst")
    mlp = block.MLP_0
    for i in range(3):
        for k in ("kernel", "bias"):
            want = d_params[f"TorchLinear_{i}"][k]
            grad = getattr(getattr(mlp, f"TorchLinear_{i}"), k).grad
            if dst_is_zero and i == 0 and k == "kernel":
                # The skipped Wd slice gets no gradient in either package.
                assert not np.asarray(want)[f : 2 * f].any() and not grad[f : 2 * f].any()
            _assert_close_to_max(grad, want, f"TorchLinear_{i}.{k}")
    _assert_close_to_max(mlp.LayerNorm_0.weight.grad, d_params["LayerNorm_0"]["scale"], "scale")
    _assert_close_to_max(mlp.LayerNorm_0.bias.grad, d_params["LayerNorm_0"]["bias"], "bias")


@pytest.mark.parametrize(
    "case",
    [
        # (batch, p_src batched, p_dst: "batched" / "broadcast" / None, e batched, LayerNorm,
        #  chunk width of the node-sum tables: 4 gives two levels, 64 one)
        (2, True, "batched", True, True, 4),
        (2, True, "broadcast", False, True, 64),
        (3, False, None, True, False, 4),
        (1, False, "broadcast", False, True, 64),  # nothing batched
    ],
    ids=["batched", "broadcast_dst_and_e", "zero_dst_no_norm", "unbatched"],
)
def test_backward_reference_matches_float64_autograd(case):
    """fused_edge_update_backward_reference against torch.autograd through
    fused_edge_update_reference, both in float64."""
    batch, src_batched, dst, e_batched, norm, chunk = case
    rng = np.random.default_rng(11)
    n_src, n_dst, n_edges, f_e, hidden = 9, 7, 60, 5, 6
    senders, receivers = _graph(rng, n_src, n_dst, n_edges)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(shift + rng.normal(size=shape) * scale).requires_grad_(True)

    lead = (batch,)
    p_src = t(*(lead if src_batched else ()), n_src, hidden)
    p_dst = None if dst is None else t(*(lead if dst == "batched" else ()), n_dst, hidden)
    e = t(*(lead if e_batched else ()), n_edges, f_e)
    weights = [t(f_e, hidden, scale=0.5), t(hidden, scale=0.1), t(hidden, hidden, scale=0.5),
               t(hidden, scale=0.1), t(hidden, f_e, scale=0.5), t(f_e, scale=0.1)]
    weights += [t(f_e, scale=0.1, shift=1.0), t(f_e, scale=0.1)] if norm else [None, None]
    s, r = torch.from_numpy(senders), torch.from_numpy(receivers)
    out = fused_mlp.fused_edge_update_reference(s, r, p_src, p_dst, e, *weights)
    assert out.dim() == (3 if (src_batched or dst == "batched" or e_batched) else 2)
    dout = torch.from_numpy(rng.normal(size=out.shape))
    inputs = [p_src, p_dst, e] + weights
    leaves = [x for x in inputs if x is not None]
    want = torch.autograd.grad(out, leaves, dout)
    tables = _tables(senders, receivers, n_src, n_dst, chunk)
    assert len(tables["sender_sum"]) == (2 if chunk == 4 else 1)
    got = fused_mlp.fused_edge_update_backward_reference(
        s, r, *(x.detach() if x is not None else None for x in inputs), dout, **tables
    )
    assert [g is None for g in got] == [x is None for x in inputs]
    got = [g for g in got if g is not None]
    for x, g, w in zip(leaves, got, want):
        assert g.shape == x.shape
        torch.testing.assert_close(g, w, atol=1e-10, rtol=0)


def _valid_args():
    rng = np.random.default_rng(12)
    senders, receivers = _graph(rng, 10, 10, 40)
    p = _params(rng, 8, 12)
    return dict(
        senders=torch.from_numpy(senders), receivers=torch.from_numpy(receivers),
        p_src=torch.randn(10, 12), p_dst=torch.randn(10, 12), e=torch.randn(40, 8),
        **dict(zip(("we", "b0", "w1", "b1", "w2", "b2", "gamma", "beta"), _weights(p))),
        **_tables(senders, receivers, 10, 10),
    )


@pytest.mark.parametrize(
    "bad, error",
    [
        (dict(senders=torch.zeros(40, dtype=torch.int64)), TypeError),
        (dict(p_src=torch.randn(10, 12, dtype=torch.float64)), TypeError),
        (dict(e=torch.randn(39, 8)), ValueError),
        (dict(p_dst=torch.randn(10, 8)), ValueError),
        (dict(we=torch.randn(9, 12)), ValueError),
        (dict(gamma=None), ValueError),
        (dict(p_src=torch.randn(12, 10).t()), ValueError),
        (dict(p_src=torch.randn(2, 10, 12), e=torch.randn(3, 40, 8)), ValueError),
        (dict(sender_sum=None), ValueError),
    ],
    ids=["int64_indices", "float64_partials", "edge_count", "dst_width", "we_shape",
         "gamma_without_beta", "column_major", "batch_sizes_differ", "no_node_sum_tables"],
)
def test_wrapper_rejects_bad_inputs(bad, error):
    args = _valid_args()
    fused_mlp.fused_edge_update(**args)  # the valid call passes
    args.update(bad)
    with pytest.raises(error):
        fused_mlp.fused_edge_update(**args)


def test_cpu_takes_float64():
    """All-float64 CPU operands take the plain versions, forward and
    backward, for reference gradients: the same as autograd through the
    plain forward (1e-10)."""
    args = {k: v.double() if torch.is_floating_point(v) else v
            for k, v in _valid_args().items() if isinstance(v, torch.Tensor)}
    leaves = {k: args[k].requires_grad_(True) for k in ("p_src", "p_dst", "e", "we", "w1", "gamma")}
    tables = {k: v for k, v in _valid_args().items() if k.endswith("_sum")}
    out = fused_mlp.fused_edge_update(**args, **tables)
    assert out.dtype == torch.float64
    dout = torch.randn(out.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, list(leaves.values()), dout)
    want = torch.autograd.grad(fused_mlp.fused_edge_update_reference(**args), list(leaves.values()), dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-10, rtol=0)


def test_cpu_path_counts_no_launch():
    args = _valid_args()
    args["we"].requires_grad_(True)
    before = fused_mlp.LAUNCHES, fused_mlp.BACKWARD_LAUNCHES
    fused_mlp.fused_edge_update(**args).sum().backward()
    assert args["we"].grad is not None
    assert (fused_mlp.LAUNCHES, fused_mlp.BACKWARD_LAUNCHES) == before


@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_chunked_csr_sums_like_index_add(chunk):
    """build_chunked_csr's levels give the sum by node id at any degree (one
    level up to `chunk` edges a node, else two), nodes without an edge 0."""
    rng = np.random.default_rng(13)
    ids = rng.integers(0, 9, 120).astype(np.int32)
    ids[ids == 4] = 5  # node 4 has no edge
    levels = build_chunked_csr(ids, 9, chunk)
    assert len(levels) == (1 if np.bincount(ids).max() <= chunk else 2)
    assert all(edge_ids.shape[1] <= chunk for edge_ids, _ in levels[:-1])
    x = torch.from_numpy(rng.normal(size=(2, 120, 3)))
    got = chunked_csr_agg(x, [tuple(map(torch.from_numpy, t)) for t in levels])
    want = torch.zeros(2, 9, 3, dtype=torch.float64).index_add_(1, torch.from_numpy(ids), x)
    torch.testing.assert_close(got, want, atol=1e-12, rtol=0)
    assert not got[:, 4].any()
    empty = build_chunked_csr(np.zeros(0, np.int32), 3, chunk)
    assert len(empty) == 1 and empty[0][0].shape == (3, 0)
