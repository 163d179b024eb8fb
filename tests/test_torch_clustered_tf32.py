"""Why the clustered attention kernels split each f32 product into three
TF32 tensor-core products, shown on the CPU.

csrc/clustered_flash.cu (K3a) and csrc/clustered_flash_bwd.cu (K3b, K3c)
run every product on mma.sync with TF32 inputs (10 mantissa bits) and f32
sums: x = big + small with big = tf32(x), small = tf32(x - big), and
a.b = (small_a.big_b + big_a.small_b) + big_a.big_b. Here the plain
versions of the forward and the backward run with each of their products
(torch.einsum) so rounded, on GenCast's own k-hop layout cut to splits 3
(642 nodes, 4 hops, 256-row blocks, mask density 7.6%, as at splits 5), and
are held against the f32 plain versions: the three-product split lands
within the kernels' limits on the card (chip_smoke.py: K3A_TOL and
K3_BWD_TOL, 1e-4), one TF32 product does not. No JAX here.
"""

import numpy as np
import pytest
import torch

from graph_weather_tpu_torch.models.gencast.graphs import build_graphcast_graphs
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
from graph_weather_tpu_torch.ops.clustered_flash import (
    clustered_flash_backward_reference,
    clustered_flash_forward_reference,
)

torch.set_num_threads(1)
K3A_TOL = 1e-4  # chip_smoke.py's limit on K3a against its plain version
K3_BWD_TOL = 1e-4  # and on K3b/K3c against the plain backward
HEADS = 2
_einsum = torch.einsum


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32 does: integer rounding of the low 13 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split3_einsum(eq, a, b):
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return (_einsum(eq, a_small, b_big) + _einsum(eq, a_big, b_small)) + _einsum(eq, a_big, b_big)


def tf32_einsum(eq, a, b):
    return _einsum(eq, tf32(a), tf32(b))


@pytest.fixture(scope="module")
def khop():
    graphs = build_graphcast_graphs(
        np.arange(0.0, 360.0, 360.0 / 32), np.linspace(-90.0, 90.0, 16), splits=3,
        num_hops=4, add_edge_features_to_khop=False, spatial_sort="rcb",
    )
    graph = DeviceGraph.from_bundle(graphs.khop, "cpu", clustered=True)
    assert graph.cluster_symmetric and graph.cluster_ids.shape == (3, 640)
    return graph


def _inputs(graph, c, seed):
    rng = np.random.default_rng(seed)
    n = graph.n_senders
    return [torch.from_numpy(rng.standard_normal((1, n, HEADS, c)).astype(np.float32))
            for _ in range(4)]


def _forward(graph, q, k, v):
    return clustered_flash_forward_reference(
        q, k, v, graph.cluster_ids, graph.cluster_masks, graph.cluster_block, with_lse=True
    )


def _backward(graph, q, k, v, dout):
    out, lse = _forward(graph, q, k, v)
    return clustered_flash_backward_reference(
        q, k, v, graph.cluster_ids, graph.cluster_masks, out, lse, dout,
        graph.cluster_block, symmetric=True,
    )


def _max_err(got, want):
    return max((a - b).abs().max().item() for a, b in zip(got, want))


@pytest.mark.parametrize("c", [128, 512])
def test_split_tf32_forward_keeps_f32_accuracy(khop, monkeypatch, c):
    q, k, v, _ = _inputs(khop, c, seed=c)
    want = _forward(khop, q, k, v)
    monkeypatch.setattr(torch, "einsum", split3_einsum)
    three = _forward(khop, q, k, v)
    monkeypatch.setattr(torch, "einsum", tf32_einsum)
    one = _forward(khop, q, k, v)
    assert _max_err(three, want) <= K3A_TOL / 10
    assert _max_err(one, want) > K3A_TOL
    # Rows without a neighbour stay exactly 0 in every split.
    empty = ~khop.cluster_masks.reshape(-1, khop.cluster_masks.shape[-1]).bool().any(-1)
    empty = empty[: q.shape[1]]
    assert all(bool((t[0][:, empty] == 0).all()) for t in (want, three, one))


@pytest.mark.parametrize("c", [128, 512])
def test_split_tf32_backward_keeps_f32_accuracy(khop, monkeypatch, c):
    q, k, v, dout = _inputs(khop, c, seed=c + 1)
    want = _backward(khop, q, k, v, dout)
    monkeypatch.setattr(torch, "einsum", split3_einsum)
    three = _backward(khop, q, k, v, dout)
    monkeypatch.setattr(torch, "einsum", tf32_einsum)
    one = _backward(khop, q, k, v, dout)
    assert _max_err(three, want) <= K3_BWD_TOL / 10
    assert _max_err(one, want) > K3_BWD_TOL
