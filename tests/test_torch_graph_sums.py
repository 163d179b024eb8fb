"""The forecaster's node sums in a fixed order, on the CPU.

A graph built with edge_sums=True (as the forecaster builds its three)
carries padded-CSR levels that sum edge rows to the receivers at any
in-degree (ops.scatter.build_chunked_csr); DeviceGraph.aggregate sums
through them, so the card repeats its bits where index_add_'s atomics did
not, and its gradient is a gather by each edge's table row. Here, on a 5°
grid's grid->mesh graph (in-degree up to 147, above the 16 of one level),
the aggregation matches index_add_ (segment_sum_agg) within 1e-6, and two
calls, forward and backward, are bit-equal; on the latent mesh the gather
gradient is bit-equal to index_select's own. A graph without the tables
keeps index_add_. No JAX here.
"""

import numpy as np
import pytest
import torch

from graph_weather_tpu_torch.meshes.graphs import build_grid_to_mesh_graph, build_latent_graph
from graph_weather_tpu_torch.meshes.hexmesh import get_hexmesh
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
from graph_weather_tpu_torch.ops.scatter import padded_csr_agg, segment_sum_agg, table_owner

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
    graph = DeviceGraph.from_bundle(g2m, "cpu")
    assert graph.receiver_sum is None and graph.csr_edge_ids is None
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
