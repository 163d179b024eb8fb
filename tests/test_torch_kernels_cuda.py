"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked `cuda` and
skips without a GPU. This file imports torch and the port only (no JAX),
so it runs on a GPU host without the JAX package's test setup:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from graph_weather_tpu_torch.ops import edge_mlp

# O(1) LayerNorm'd outputs; sums over up to 768 products in another order.
ATOL = 1e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _args(gen, b, n_src, n_dst, n_edges, f, f_e, hidden, dst, e_batched, norm=True):
    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    senders = torch.randint(0, n_src, (n_edges,), generator=gen, device="cuda")
    receivers = torch.randint(0, n_dst, (n_edges,), generator=gen, device="cuda")
    k0 = 2 * f + f_e
    x_dst = {"yes": rnd(b, n_dst, f), "none": None, "expand": rnd(1, n_dst, f).expand(b, n_dst, f)}
    return (
        senders.int(), receivers.sort().values.int(), rnd(b, n_src, f), x_dst[dst],
        rnd(b, n_edges, f_e) if e_batched else rnd(n_edges, f_e),
        rnd(k0, hidden, scale=k0**-0.5), rnd(hidden, scale=0.1),
        rnd(hidden, hidden, scale=hidden**-0.5), rnd(hidden, scale=0.1),
        rnd(hidden, f_e, scale=hidden**-0.5), rnd(f_e, scale=0.1),
        1.0 + rnd(f_e, scale=0.1) if norm else None,
        rnd(f_e, scale=0.1) if norm else None,
    )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    [
        # b, n_src, n_dst, n_edges, F, Fe, H, x_dst, batched e, LayerNorm
        (1, 300, 100, 1000, 256, 256, 256, "yes", False, True),
        (2, 300, 100, 1000, 16, 24, 48, "expand", True, True),
        (3, 50, 700, 2050, 256, 256, 256, "none", False, True),
        (1, 9, 9, 5, 7, 5, 3, "yes", True, True),
        (2, 64, 64, 129, 100, 60, 200, "yes", True, False),
    ],
    ids=["full_width", "narrow_batched", "zero_dst_ragged", "tiny_odd", "no_norm"],
)
def test_fused_edge_mlp_matches_plain(gen, shape):
    args = _args(gen, *shape)
    with torch.no_grad():
        before = edge_mlp.LAUNCHES
        out = edge_mlp.fused_edge_mlp(*args)
        torch.cuda.synchronize()
        assert edge_mlp.LAUNCHES == before + 1
        ref = edge_mlp.fused_edge_mlp_reference(*args)
    assert out.shape == ref.shape
    assert (out - ref).abs().max().item() <= ATOL


@pytest.mark.cuda
def test_fused_edge_mlp_refuses_grad(gen):
    args = list(_args(gen, 1, 8, 8, 16, 8, 8, 8, "yes", False))
    args[5].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        edge_mlp.fused_edge_mlp(*args)


@pytest.mark.cuda
def test_fused_edge_mlp_empty_graph_launches_nothing(gen):
    args = _args(gen, 1, 8, 8, 0, 8, 8, 8, "yes", False)
    before = edge_mlp.LAUNCHES
    with torch.no_grad():
        out = edge_mlp.fused_edge_mlp(*args)
    assert out.shape == (1, 0, 8) and edge_mlp.LAUNCHES == before
