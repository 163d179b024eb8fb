"""Why the fused edge update's kernels split each f32 product into three
TF32 tensor-core products, shown on the CPU.

csrc/edge_mlp.cu (K1, K2) and csrc/fused_mlp_bwd.cu (K2b) run every product
on mma.sync with TF32 inputs (10 mantissa bits) and f32 sums: x = big +
small with big = tf32(x) and small = tf32(x - big), and a.b = (small_a.big_b
+ big_a.small_b) + big_a.big_b (csrc/edge_tile.cuh, by clustered_tile.cuh's
split). Here the plain forward and backward of ops/fused_mlp.py run with
each of their products so rounded, at the forecaster's width (256) on a
random graph of 2,000 edges, and are held
against the f32 plain versions: the three-product split lands within the
kernels' limits on the card (chip_smoke.py: K1_TOL, 1e-4 of the outputs;
K2B_TOL, 1e-4 of each gradient's max|g|), one TF32 product does not. The
backward runs at the f32 forward's ReLU masks, as the card's checks do. No
JAX here.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from graph_weather_tpu_torch.ops import fused_mlp
from graph_weather_tpu_torch.ops.scatter import build_chunked_csr

torch.set_num_threads(1)
K1_TOL = 1e-4  # chip_smoke.py's limit on K2 against its plain version
K2B_TOL = 1e-4  # and on K2b's gradients, of each tensor's max|g|
WIDTH, N_EDGES, N_SRC, N_DST = 256, 2000, 500, 300
_TF32_MASK = ~0x1FFF


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ctile::rna_tf32 does: integer rounding of the low 13 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & _TF32_MASK).view(torch.float32)


def split3_matmul(a, b):
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return (torch.matmul(a_small, b_big) + torch.matmul(a_big, b_small)) + torch.matmul(a_big, b_big)


def tf32_matmul(a, b):
    return torch.matmul(tf32(a), tf32(b))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    senders = rng.integers(0, N_SRC, N_EDGES).astype(np.int32)
    receivers = np.sort(rng.integers(0, N_DST, N_EDGES)).astype(np.int32)
    w = WIDTH
    args = (
        torch.from_numpy(senders), torch.from_numpy(receivers),
        rnd(1, N_SRC, w), rnd(1, N_DST, w), rnd(N_EDGES, w),
        rnd(w, w, scale=w**-0.5), rnd(w, scale=0.1),
        rnd(w, w, scale=w**-0.5), rnd(w, scale=0.1),
        rnd(w, w, scale=w**-0.5), rnd(w, scale=0.1),
        1.0 + rnd(w, scale=0.1), rnd(w, scale=0.1),
    )
    tables = dict(
        sender_sum=[tuple(torch.as_tensor(a) for a in t) for t in build_chunked_csr(senders, N_SRC)],
        receiver_sum=[tuple(torch.as_tensor(a) for a in t) for t in build_chunked_csr(receivers, N_DST)],
    )
    return args, tables, rnd(1, N_EDGES, w)


def _forward(args):
    return fused_mlp.fused_edge_update_reference(*args)


def _backward(args, tables, dout, activations):
    return fused_mlp.fused_edge_update_backward_reference(
        *args, dout, **tables, activations=activations
    )


def _worst_relative(got, want):
    return max((g - w).abs().max().item() / w.abs().max().item()
               for g, w in zip(got, want) if w is not None)


def test_split_tf32_forward_keeps_f32_accuracy(case, monkeypatch):
    args, _, _ = case
    want = _forward(args)
    monkeypatch.setattr(torch.Tensor, "__matmul__", split3_matmul)
    three = _forward(args)
    monkeypatch.setattr(torch.Tensor, "__matmul__", tf32_matmul)
    one = _forward(args)
    assert (three - want).abs().max().item() <= K1_TOL
    assert (one - want).abs().max().item() > K1_TOL


def test_split_tf32_backward_keeps_f32_accuracy(case, monkeypatch):
    args, tables, dout = case
    activations = fused_mlp.fused_edge_update_activations(*args[:9])
    want = _backward(args, tables, dout, activations)
    monkeypatch.setattr(torch.Tensor, "__matmul__", split3_matmul)
    three = _backward(args, tables, dout, activations)
    monkeypatch.setattr(torch.Tensor, "__matmul__", tf32_matmul)
    one = _backward(args, tables, dout, activations)
    assert _worst_relative(three, want) <= K2B_TOL
    assert _worst_relative(one, want) > K2B_TOL


def test_tile_edges_match_the_kernels_tile():
    """ops/fused_mlp.TILE_EDGES sizes K2b's column-sum buffer: it is the
    kernels' own tile (TE in csrc/edge_tile.cuh)."""
    header = (Path(fused_mlp.__file__).parents[1] / "csrc" / "edge_tile.cuh").read_text()
    te = re.search(r"constexpr int TE = (\d+);", header)
    assert te is not None and int(te.group(1)) == fused_mlp.TILE_EDGES
