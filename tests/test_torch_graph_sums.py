"""Node sums in a fixed order, on the CPU.

A graph built with edge_sums=True (as the forecaster builds its three)
carries padded-CSR levels that sum edge rows to the receivers at any
in-degree (ops.scatter.build_chunked_csr); DeviceGraph.aggregate sums
through them, so the card repeats its bits where index_add_'s atomics did
not, and its gradient is a gather by each edge's table row. Here, on a 5°
grid's grid->mesh graph (in-degree up to 147, above the 16 of one level),
the aggregation matches index_add_ (segment_sum_agg) within 1e-6, and two
calls, forward and backward, are bit-equal; on the latent mesh the gather
gradient is bit-equal to index_select's own. A graph without the tables
(the GenCast family's) sums in edge order (S in f32, ops.scatter.
edge_order_sum), which on the CPU adds as index_add_ does; its gathers onto
edges have S as their gradient, and no sum on GenCast's or FGN's paths, f32
or bf16, reaches index_add_ (by the route DeviceGraph.sum_route names and by
the nodes of the autograd graph). WeatherMesh's resize backward on the card
(a product with the interpolation weights) is F.interpolate's gradient.
No JAX here.
"""

import numpy as np
import pytest
import torch

from graph_weather_tpu_torch.meshes.graphs import build_grid_to_mesh_graph, build_latent_graph
from graph_weather_tpu_torch.meshes.hexmesh import get_hexmesh
from graph_weather_tpu_torch import Denoiser, FunctionalGenerativeNetwork
from graph_weather_tpu_torch.models.weathermesh.model import _Resize
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
from graph_weather_tpu_torch.ops import scatter
from graph_weather_tpu_torch.ops.scatter import (
    build_flat_csr,
    edge_order_sum,
    edge_order_sum_reference,
    gather_rows,
    padded_csr_agg,
    segment_sum_agg,
    table_owner,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def g2m():
    lats, lons = np.arange(-90.0, 90.0, 5.0), np.arange(0.0, 360.0, 5.0)
    lat_lons = np.array([(a, b) for a in lats for b in lons])
    bundle = build_grid_to_mesh_graph(lat_lons, get_hexmesh(0))
    assert np.bincount(bundle.receivers).max() > 16
    return bundle


@pytest.mark.parametrize("batch", [None, 2])
def test_aggregate_sums_through_the_tables(g2m, batch):
    graph = DeviceGraph.from_bundle(g2m, "cpu", edge_sums=True)
    assert graph.csr_edge_ids is None and len(graph.receiver_sum) == 2
    rng = np.random.default_rng(0)
    shape = (g2m.n_edges, 16) if batch is None else (batch, g2m.n_edges, 16)
    edges = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    want = segment_sum_agg(edges, graph.receivers.long(), graph.n_receivers)
    got = graph.aggregate(edges)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-6 * max(1.0, want.abs().max().item())
    assert torch.equal(graph.aggregate(edges), got)


def test_aggregate_repeats_its_bits_forward_and_backward(g2m):
    graph = DeviceGraph.from_bundle(g2m, "cpu", edge_sums=True)
    rng = np.random.default_rng(1)
    edges = torch.from_numpy(rng.standard_normal((2, g2m.n_edges, 8)).astype(np.float32))
    weights = torch.from_numpy(rng.standard_normal((2, g2m.n_receivers, 8)).astype(np.float32))

    def run():
        x = edges.clone().requires_grad_(True)
        out = graph.aggregate(x)
        (out * weights).sum().backward()
        return out.detach(), x.grad

    (out_a, grad_a), (out_b, grad_b) = run(), run()
    assert torch.equal(out_a, out_b) and torch.equal(grad_a, grad_b)
    # Each edge's gradient is its receiver's weight row, exactly.
    assert torch.equal(grad_a, weights[:, graph.receivers.long()])


def test_aggregate_without_tables_keeps_index_add(g2m):
    """A graph without tables sums in edge order (S's route, fixed on the
    card too), which on the CPU gives index_add_'s bits: both add each
    node's edges one at a time in edge order."""
    graph = DeviceGraph.from_bundle(g2m, "cpu")
    assert graph.receiver_sum is None and graph.csr_edge_ids is None
    assert graph.sum_route(torch.float32) == "edge_order"
    edges = torch.from_numpy(np.random.default_rng(2).standard_normal((g2m.n_edges, 4)).astype(np.float32))
    want = segment_sum_agg(edges, graph.receivers.long(), graph.n_receivers)
    assert torch.equal(graph.aggregate(edges), want)


def test_table_sum_gradient_is_a_gather_of_the_same_bits():
    """The latent mesh's one table (in-degree <= 7): with its owners
    (edge_sums=True) the gradient is a gather by each edge's table row, and
    bit-equal to index_select's own gradient (index_add_ of the padded
    entries), which the table without owners takes."""
    bundle = build_latent_graph(get_hexmesh(1))
    graph = DeviceGraph.from_bundle(bundle, "cpu", edge_sums=True)
    ids, mask, owner = graph.receiver_sum[0]
    assert ids is graph.csr_edge_ids and owner.shape == (bundle.n_edges,)
    rng = np.random.default_rng(3)
    edges = torch.from_numpy(rng.standard_normal((1, bundle.n_edges, 8)).astype(np.float32))
    weights = torch.from_numpy(rng.standard_normal((1, bundle.n_receivers, 8)).astype(np.float32))
    x, y = (edges.clone().requires_grad_(True) for _ in range(2))
    got, want = graph.aggregate(x), padded_csr_agg(y, ids, mask)
    assert torch.equal(got, want)
    (got * weights).sum().backward()
    (want * weights).sum().backward()
    assert torch.equal(x.grad, y.grad)


def test_table_owner_refuses_a_row_held_twice():
    ids = np.array([[0, 1], [1, 0]], dtype=np.int32)
    mask = np.array([[True, True], [True, False]])
    with pytest.raises(ValueError, match="exactly one"):
        table_owner(ids, mask, 2)
    assert table_owner(ids, np.array([[True, True], [False, False]]), 2).tolist() == [0, 0]


@pytest.mark.parametrize("batch", [None, 3])
def test_edge_order_sum_f32_matches_index_add_and_repeats(batch):
    """S in f32 (its plain version on the CPU) over unsorted ids with empty
    nodes and one node of 600 edges: within f32 summation tolerance of
    index_add_, bit-equal over two calls, no launch on the CPU; its
    gradient a gather by each edge's node."""
    rng = np.random.default_rng(5)
    ids = np.concatenate([rng.integers(0, 90, 2000), np.full(600, 17)]).astype(np.int32)
    ids = rng.permutation(ids[ids % 11 != 3])
    offsets, edge_ids = (torch.from_numpy(a) for a in build_flat_csr(ids, 90))
    shape = (ids.size, 24) if batch is None else (batch, ids.size, 24)
    rows = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    launches = scatter.LAUNCHES, scatter.F32_LAUNCHES
    got = edge_order_sum(rows, offsets, edge_ids)
    want = segment_sum_agg(rows.double(), torch.from_numpy(ids).long(), 90)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got.double() - want).abs().max().item() <= 1e-6 * max(1.0, want.abs().max().item())
    assert torch.equal(edge_order_sum(rows, offsets, edge_ids), got)
    assert torch.equal(edge_order_sum_reference(rows, offsets, edge_ids), got)
    assert (scatter.LAUNCHES, scatter.F32_LAUNCHES) == launches
    x = rows.clone().requires_grad_(True)
    weights = torch.randn(got.shape, generator=torch.Generator().manual_seed(0))
    (edge_order_sum(x, offsets, edge_ids, nodes=torch.from_numpy(ids).long()) * weights).sum().backward()
    assert torch.equal(x.grad, weights.index_select(-2, torch.from_numpy(ids).long()))
    with pytest.raises(ValueError, match="nodes"):
        edge_order_sum(rows.clone().requires_grad_(True), offsets, edge_ids)


def test_gather_gradient_is_edge_order_sum():
    """gather_rows onto edges: the gather index_select gives, and a
    gradient that sums each node's edges in edge order (S), within f32
    tolerance of index_select's own (index_add_) gradient, bit-equal over
    two runs."""
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 50, 700).astype(np.int32)
    index, csr = torch.from_numpy(ids), tuple(torch.from_numpy(a) for a in build_flat_csr(ids, 50))
    x0 = torch.from_numpy(rng.standard_normal((2, 50, 8)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, 700, 8)).astype(np.float32))

    def grad(fn):
        x = x0.clone().requires_grad_(True)
        out = fn(x)
        (out * cot).sum().backward()
        return out.detach(), x.grad

    got, got_grad = grad(lambda x: gather_rows(x, index, csr))
    want, want_grad = grad(lambda x: x.index_select(-2, index.long()))
    assert torch.equal(got, want)
    assert (got_grad - want_grad).abs().max().item() <= 1e-5
    assert torch.equal(grad(lambda x: gather_rows(x, index, csr))[1], got_grad)


GRID = dict(grid_lon=np.arange(0.0, 360.0, 360.0 / 32), grid_lat=np.linspace(-90.0, 90.0, 16),
            hidden_dims=(16, 16), num_blocks=2, num_heads=2, splits=2, num_hops=2)
FAMILY = {
    "denoiser_clustered": (Denoiser, dict(GRID, input_features_dim=3, output_features_dim=3,
                                          use_edges_features=False, attention_impl="clustered_flash")),
    "fgn_clustered": (FunctionalGenerativeNetwork, dict(
        GRID, input_features_dim=3, output_features_dim=3, noise_dimension=4,
        use_edges_features=False, attention_impl="clustered_flash")),
    "fgn_segment": (FunctionalGenerativeNetwork, dict(
        GRID, input_features_dim=3, output_features_dim=3, noise_dimension=4,
        use_edges_features=True, attention_impl="segment")),
}
# Autograd nodes whose backward sums with index_add_ (atomics on the card).
ATOMIC_BACKWARDS = ("IndexSelectBackward", "IndexAddBackward", "IndexBackward", "EmbeddingBackward")


def _backward_nodes(out):
    seen, stack = set(), [out.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(next_fn for next_fn, _ in node.next_functions)
    return {type(node).__name__ for node in seen}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(FAMILY))
def test_gencast_family_sums_take_fixed_order_routes(name, dtype):
    """On GenCast's and FGN's graphs (g2m, the k-hop mesh, m2g) every sum
    to the receivers takes a fixed-order route (never `index_add`), and the
    forward of a train step builds no autograd node whose backward is
    index_add_: the card path is the same Python, with the kernels (S, K3a,
    K3c) in place of the plain versions."""
    cls, kw = FAMILY[name]
    model = cls(**kw, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    bf16 = torch.bfloat16 if dtype == "bf16" else None
    for graph in (model.g2m, model.khop, model.m2g):
        for rows in (torch.float32, torch.bfloat16):
            assert graph.sum_route(rows) != "index_add"
    assert model.g2m.sum_route(torch.float32) == "edge_order"
    assert model.m2g.sum_route(torch.float32) == "padded_csr" and model.m2g.csr_owner is not None
    rng = np.random.default_rng(7)
    if cls is Denoiser:
        inputs = (rng.normal(size=(1, 32, 16, 3)), rng.normal(size=(1, 32, 16, 6)), np.ones((1, 1)))
        out = model.forward_fn(compute_dtype=bf16)(*(a.astype(np.float32) for a in inputs))
    else:
        prev, z = rng.normal(size=(1, 32, 16, 3)), rng.normal(size=(1, 4))
        out = model.member_fn(compute_dtype=bf16)(prev.astype(np.float32), z.astype(np.float32))
    nodes = _backward_nodes(out.sum())
    assert not [n for n in nodes if n.startswith(ATOMIC_BACKWARDS)], nodes
    out.sum().backward()
    assert all(p.grad is not None for p in model.module.parameters())


@pytest.mark.parametrize("mode,shape", [("bilinear", (2, 3, 5, 7)), ("trilinear", (1, 2, 3, 4, 6))])
def test_resize_backward_is_interpolate_gradient(mode, shape):
    """WeatherMesh's x2 resize of H and W (_Resize, which its f32 decoder
    takes on the card): the forward is F.interpolate's, and the backward, a
    product with the interpolation weights (no atomics), is F.interpolate's
    gradient within f32 rounding."""
    scale = (2, 2) if mode == "bilinear" else (1, 2, 2)
    x0 = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    up = tuple(n * s for n, s in zip(shape[2:], scale))
    cot = torch.randn(shape[:2] + up, generator=torch.Generator().manual_seed(2))
    grads = []
    for fn in (lambda x: _Resize.apply(x, scale, mode),
               lambda x: torch.nn.functional.interpolate(x, scale_factor=scale, mode=mode,
                                                         align_corners=False)):
        x = x0.clone().requires_grad_(True)
        out = fn(x)
        (out * cot).sum().backward()
        grads.append((out.detach(), x.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert (grads[0][1] - grads[1][1]).abs().max().item() <= 1e-5
