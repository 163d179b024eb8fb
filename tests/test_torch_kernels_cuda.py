"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked `cuda` and
skips without a GPU. This file imports torch and the port only (no JAX),
so it runs on a GPU host without the JAX package's test setup:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from graph_weather_tpu_torch.meshes.clustering import (
    build_cluster_layout,
    build_cluster_scatter_index,
    is_symmetric_edges,
)
from graph_weather_tpu_torch.nn import bf16
from graph_weather_tpu_torch.ops import (
    banded_flash,
    clustered_flash,
    edge_mlp,
    fused_mlp,
    natten3d,
    natten_flash,
    scatter,
)
from graph_weather_tpu_torch.ops.banded_attention import build_band_masks
from graph_weather_tpu_torch.ops.scatter import build_chunked_csr, build_flat_csr
from graph_weather_tpu_torch.ops.neighborhood_attention import (
    neighborhood_attention_3d,
    neighborhood_attention_3d_reference,
    route,
)

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


EDGE_SHAPES = [
    # b, n_src, n_dst, n_edges, F, Fe, H, x_dst, batched e, LayerNorm
    (1, 300, 100, 1000, 256, 256, 256, "yes", False, True),
    (2, 300, 100, 1000, 16, 24, 48, "expand", True, True),
    (3, 50, 700, 2050, 256, 256, 256, "none", False, True),
    (1, 9, 9, 5, 7, 5, 3, "yes", True, True),
    (2, 64, 64, 129, 100, 60, 200, "yes", True, False),
]
EDGE_IDS = ["full_width", "narrow_batched", "zero_dst_ragged", "tiny_odd", "no_norm"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=EDGE_IDS)
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
    with pytest.raises(NotImplementedError, match="fused_edge_update"):
        edge_mlp.fused_edge_mlp(*args)


@pytest.mark.cuda
def test_fused_edge_mlp_empty_graph_launches_nothing(gen):
    args = _args(gen, 1, 8, 8, 0, 8, 8, 8, "yes", False)
    before = edge_mlp.LAUNCHES
    with torch.no_grad():
        out = edge_mlp.fused_edge_mlp(*args)
    assert out.shape == (1, 0, 8) and edge_mlp.LAUNCHES == before


def _k2_args(gen, b, n_src, n_dst, n_edges, f, f_e, hidden, dst, e_batched, norm=True):
    """K2's operands at a K1 test shape: partials [b, N, H] (an expand()ed
    [N, H] for "expand"), and the K1 weights' We slice. F only sizes W0."""
    s, r, _, _, e, w0, *rest = _args(gen, b, n_src, n_dst, n_edges, f, f_e, hidden, dst,
                                     e_batched, norm)
    p_src = torch.randn(b, n_src, hidden, generator=gen, device="cuda")
    p_dst = {"yes": torch.randn(b, n_dst, hidden, generator=gen, device="cuda"), "none": None,
             "expand": torch.randn(1, n_dst, hidden, generator=gen, device="cuda").expand(b, n_dst, hidden)}
    return (s, r, p_src, p_dst[dst], e, w0[-f_e:].contiguous(), *rest)


def _tables(args):
    """Padded CSR levels of both sides, as DeviceGraph builds them."""
    s, r, p_src = args[0].cpu().numpy(), args[1].cpu().numpy(), args[2]
    n_dst = args[3].shape[-2] if args[3] is not None else int(r.max()) + 1
    return dict(
        sender_sum=[tuple(torch.as_tensor(a, device="cuda") for a in t)
                    for t in build_chunked_csr(s, p_src.shape[-2])],
        receiver_sum=[tuple(torch.as_tensor(a, device="cuda") for a in t)
                      for t in build_chunked_csr(r, n_dst)],
    )


def _max_rel(got, want):
    """Largest error of each gradient over that tensor's max|g|."""
    worst = 0.0
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.shape == w.shape
            worst = max(worst, (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30))
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=EDGE_IDS)
def test_fused_edge_update_matches_plain(gen, shape):
    """K2 (K1's partial-product mode) against its plain version."""
    args = _k2_args(gen, *shape)
    with torch.no_grad():
        before = fused_mlp.LAUNCHES
        out = fused_mlp.fused_edge_update(*args, **_tables(args))
        torch.cuda.synchronize()
        assert fused_mlp.LAUNCHES == before + 1
        ref = fused_mlp.fused_edge_update_reference(*args)
    assert out.shape == ref.shape
    assert (out - ref).abs().max().item() <= ATOL


def _kernel_activations(args, dout):
    """K2b's recomputed (h0, h1), held against the plain ones (within ATOL
    in f32, BF16_TOL of their max in bf16); the kernel is deterministic, so
    every launch on these inputs draws the same ReLU masks."""
    (h0, h1, *_), _ = fused_mlp.launch_backward(*args[:12], dout)
    want = fused_mlp.fused_edge_update_activations(*args[:9])
    for got, ref in zip((h0, h1), want):
        if got.dtype == torch.bfloat16:  # BF16_TOL: with the bf16 kernels below
            assert _bf16_err(got, ref.expand(got.shape)) <= 1.0
        else:
            assert (got - ref.expand(got.shape)).abs().max().item() <= ATOL
    return h0, h1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=EDGE_IDS)
def test_fused_edge_update_backward_matches_plain(gen, shape):
    """K2b and the sums after it against the plain backward on the card, at
    the kernel's ReLU masks (its h0 and h1 within 1e-4 of the plain ones):
    every gradient within 1e-4 of its tensor's max|g|; one K2b launch."""
    args = _k2_args(gen, *shape)
    dout = torch.randn(shape[0], shape[3], shape[5], generator=gen, device="cuda")
    tables = _tables(args)
    activations = _kernel_activations(args, dout)
    before = fused_mlp.BACKWARD_LAUNCHES
    got = fused_mlp._backward_cuda(*args, dout, tables["sender_sum"], tables["receiver_sum"])
    torch.cuda.synchronize()
    assert fused_mlp.BACKWARD_LAUNCHES == before + 1
    want = fused_mlp.fused_edge_update_backward_reference(
        *args, dout, **tables, activations=activations
    )
    assert _max_rel(got, want) <= 1e-4


def _masked_forward(s, r, p_src, p_dst, e, we, b0, w1, b1, w2, b2, gamma, beta, masks):
    """The plain forward with each ReLU replaced by the given 0/1 mask."""
    h = p_src.index_select(-2, s)
    if p_dst is not None:
        h = h + p_dst.index_select(-2, r)
    h = (h + e @ we + b0) * masks[0]
    h = (h @ w1 + b1) * masks[1]
    h = h @ w2 + b2
    if gamma is not None:
        h = torch.nn.functional.layer_norm(h, (h.shape[-1],), gamma, beta, eps=1e-5)
    return h + e


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=EDGE_IDS)
def test_fused_edge_update_gradients_match_float64(gen, shape):
    """Gradients through the Function on the card (K2, K2b) against float64
    autograd of the plain forward on the CPU, at the kernel's ReLU masks."""
    args = _k2_args(gen, *shape)
    leaves = [a.detach().clone().requires_grad_(True) if a is not None and a.is_floating_point()
              else a for a in args]
    if shape[7] == "expand":  # keep the broadcast view: its gradient sums over the batch
        leaves[3] = args[3][0].detach().clone().requires_grad_(True)
        p_dst = leaves[3].expand(args[3].shape)
    else:
        p_dst = leaves[3]
    out = fused_mlp.fused_edge_update(*leaves[:3], p_dst, *leaves[4:], **_tables(args))
    dout = torch.randn(out.shape, generator=gen, device="cuda")
    grads = torch.autograd.grad(out, [t for t in leaves[2:] if t is not None], dout)
    cpu = [a.detach().double().cpu().requires_grad_(True) if a is not None and a.is_floating_point()
           else (a.cpu() if a is not None else None) for a in leaves]
    cpu_dst = cpu[3].expand(args[3].shape) if shape[7] == "expand" else cpu[3]
    masks = [(h > 0).double().cpu() for h in _kernel_activations(args, dout)]
    ref = _masked_forward(*cpu[:3], cpu_dst, *cpu[4:], masks)
    want = torch.autograd.grad(ref, [t for t in cpu[2:] if t is not None], dout.double().cpu())
    assert _max_rel([g.double().cpu() for g in grads], want) <= 1e-4


@pytest.mark.cuda
def test_fused_edge_update_empty_graph_launches_nothing(gen):
    args = [a.requires_grad_(True) if a is not None and a.is_floating_point() else a
            for a in _k2_args(gen, 1, 8, 8, 0, 8, 8, 8, "yes", False)]
    before = fused_mlp.LAUNCHES, fused_mlp.BACKWARD_LAUNCHES
    out = fused_mlp.fused_edge_update(*args, **_tables(args))
    assert out.shape == (1, 0, 8)
    out.sum().backward()
    assert args[2].grad.abs().max().item() == 0 and args[5].grad.abs().max().item() == 0
    assert (fused_mlp.LAUNCHES, fused_mlp.BACKWARD_LAUNCHES) == before


# The tensor-core tiles of K2 and K2b at their edges: one tile of edges, one
# tile less or more one edge (the last tile holding a single valid edge), a
# single edge; widths 8, 200 and 256 with Fe != H (mma wants multiples of 8
# of the padded tiles; these are the widths that fill a tile, one n-tile,
# and neither).
_TE = fused_mlp.TILE_EDGES
TILE_EDGES_CASES = [_TE, _TE - 1, _TE + 1, 1]
TILE_WIDTHS = [(8, 200), (200, 256), (256, 8)]  # (Fe, H)


@pytest.mark.cuda
@pytest.mark.parametrize("widths", TILE_WIDTHS, ids=["fe8_h200", "fe200_h256", "fe256_h8"])
@pytest.mark.parametrize("n_edges", TILE_EDGES_CASES, ids=["tile", "tile_less_1", "tile_plus_1", "one"])
def test_fused_edge_update_tiles_match_plain(gen, n_edges, widths):
    """K2 and K2b (with the sums after it) against their plain versions at
    the tile's edges, batched, with a destination term and the LayerNorm."""
    f_e, hidden = widths
    args = _k2_args(gen, 2, 40, 30, n_edges, 8, f_e, hidden, "yes", True)
    tables = _tables(args)
    with torch.no_grad():
        out = fused_mlp.fused_edge_update(*args, **tables)
        torch.cuda.synchronize()
        assert (out - fused_mlp.fused_edge_update_reference(*args)).abs().max().item() <= ATOL
    dout = torch.randn(2, n_edges, f_e, generator=gen, device="cuda")
    activations = _kernel_activations(args, dout)
    got = fused_mlp._backward_cuda(*args, dout, tables["sender_sum"], tables["receiver_sum"])
    want = fused_mlp.fused_edge_update_backward_reference(
        *args, dout, **tables, activations=activations
    )
    assert _max_rel(got, want) <= 1e-4


@pytest.mark.cuda
def test_fused_edge_update_backward_repeats_its_bits(gen):
    """Two K2b launches on the same inputs write the same bits: no atomics,
    every sum in a fixed order."""
    args = _k2_args(gen, 2, 300, 100, 3 * _TE + 5, 256, 256, 256, "yes", True)
    dout = torch.randn(2, 3 * _TE + 5, 256, generator=gen, device="cuda")
    first_outs, first_sums = fused_mlp.launch_backward(*args[:12], dout)
    second_outs, second_sums = fused_mlp.launch_backward(*args[:12], dout)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first_outs, second_outs))
    assert all(torch.equal(first_sums[k], second_sums[k]) for k in first_sums)


def _flat_csrs(args):
    """The flat CSRs of both sides (build_flat_csr), as DeviceGraph builds them."""
    s, r, p_src = args[0].cpu().numpy(), args[1].cpu().numpy(), args[2]
    n_dst = args[3].shape[-2] if args[3] is not None else int(r.max()) + 1
    return dict(
        sender_csr=tuple(torch.as_tensor(a, device="cuda") for a in build_flat_csr(s, p_src.shape[-2])),
        receiver_csr=tuple(torch.as_tensor(a, device="cuda") for a in build_flat_csr(r, n_dst)),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=EDGE_IDS)
def test_fused_edge_update_bf16_matches_plain(gen, shape):
    """K2 and K2b in bf16 (with S's sums to the nodes) against their plain
    versions on bf16 operands: one launch of each bf16 kernel, bf16
    outputs and gradients within BF16_TOL, K2b at its own ReLU masks (its
    recomputed h0 and h1 within BF16_TOL of the plain ones)."""
    args = tuple(a.bfloat16() if a is not None and a.is_floating_point() else a
                 for a in _k2_args(gen, *shape))
    tables = {**_tables(args), **_flat_csrs(args)}
    with torch.no_grad():
        before = fused_mlp.BF16_LAUNCHES
        out = fused_mlp.fused_edge_update(*args, **tables)
        torch.cuda.synchronize()
        assert fused_mlp.BF16_LAUNCHES == before + 1
        ref = fused_mlp.fused_edge_update_reference(*args)
        assert out.dtype == torch.bfloat16 and out.shape == ref.shape
        assert _bf16_err(out, ref) <= 1.0
    dout = torch.randn(shape[0], shape[3], shape[5], generator=gen, device="cuda").bfloat16()
    h0, h1 = _kernel_activations(args, dout)
    before = fused_mlp.BF16_BACKWARD_LAUNCHES
    got = fused_mlp._backward_cuda(*args, dout, *(tables[k] for k in (
        "sender_sum", "receiver_sum", "sender_csr", "receiver_csr")))
    torch.cuda.synchronize()
    assert fused_mlp.BF16_BACKWARD_LAUNCHES == before + 1
    want = fused_mlp.fused_edge_update_backward_reference(
        *args, dout, tables["sender_sum"], tables["receiver_sum"], activations=(h0, h1),
        sender_csr=tables["sender_csr"], receiver_csr=tables["receiver_csr"],
    )
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            assert _bf16_err(g, w) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 7, 256])
@pytest.mark.parametrize("batch", [1, 3])
def test_segment_sum_bf16_matches_plain(gen, width, batch):
    """S against its plain version, bit for bit, over unsorted ids with empty
    nodes and one node of 600 edges; a second launch repeats its bits."""
    rng = np.random.default_rng(width + batch)
    ids = np.concatenate([rng.integers(0, 90, 2000), np.full(600, 17)]).astype(np.int32)
    ids = rng.permutation(ids[ids % 11 != 3])
    offsets, edge_ids = (torch.as_tensor(a, device="cuda") for a in build_flat_csr(ids, 90))
    rows = torch.randn(batch, ids.size, width, generator=gen, device="cuda").bfloat16()
    before = scatter.LAUNCHES
    got = scatter.segment_sum_bf16(rows, offsets, edge_ids)
    again = scatter.segment_sum_bf16(rows, offsets, edge_ids)
    torch.cuda.synchronize()
    assert scatter.LAUNCHES == before + 2
    want = scatter.edge_order_sum_reference(rows, offsets, edge_ids)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(1, 5, 7, 9), (1, 14, 45, 90)], ids=["serial", "latent_1deg"])
def test_bias_add_grad_on_s_matches_cpu(gen, dims):
    """nn.bf16.bias_add's bias gradient (XLA:CPU's windowed bf16 sum, one S
    launch a level) on the card against the same function on the CPU, bit
    for bit, at the tests' latent (one level) and the 1 degree latent (two:
    6 windows, then their sum)."""
    cot = torch.randn(*dims, 384, generator=gen, device="cuda").bfloat16()

    def bias_grad(grad):
        bias = torch.zeros(grad.shape[-1], dtype=torch.bfloat16, device=grad.device, requires_grad=True)
        bf16.bias_add(torch.zeros_like(grad), bias).backward(grad)
        return bias.grad

    before = scatter.LAUNCHES
    got = bias_grad(cot)
    torch.cuda.synchronize()
    assert scatter.LAUNCHES == before + len(bf16.xla_sum_order(dims))
    assert torch.equal(got.cpu(), bias_grad(cot.cpu()))


def _cluster_case(gen, b, n, heads, c, block, empty_every=7, seed=0):
    """A random graph whose every 7th receiver has no edge, laid out in
    `block`-row blocks; q/k/v [b, n, heads, c] on the card."""
    rng = np.random.default_rng(seed)
    receivers = np.repeat(np.arange(n), 6)
    senders = (receivers + rng.integers(-40, 41, receivers.size)) % n
    keep = receivers % empty_every != 0
    layout = build_cluster_layout(senders[keep], receivers[keep], n, n, block=block)
    ids = torch.as_tensor(layout.gather_ids, device="cuda")
    masks = torch.as_tensor(layout.masks.astype(np.int8), device="cuda")
    q, k, v = (torch.randn(b, n, heads, c, generator=gen, device="cuda") for _ in range(3))
    empty = ~layout.masks.reshape(-1, layout.u_pad).any(-1)[:n]
    return q, k, v, ids, masks, block, torch.as_tensor(empty, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("c", [16, 128, 512])
def test_clustered_flash_matches_plain(gen, c, batch):
    """A ragged layout (700 rows in 256-row blocks, so padded rows exist),
    empty receiver rows, B in {1, 2}: kernel against its plain version,
    and exact zeros on the empty rows."""
    q, k, v, ids, masks, block, empty = _cluster_case(gen, batch, 700, 4, c, 256)
    with torch.no_grad():
        before = clustered_flash.LAUNCHES
        out = clustered_flash.clustered_flash_attention(q, k, v, ids, masks, block)
        torch.cuda.synchronize()
        assert clustered_flash.LAUNCHES == before + 1
        ref = clustered_flash.clustered_flash_forward_reference(q, k, v, ids, masks, block)
    assert out.shape == ref.shape == q.shape
    assert (out - ref).abs().max().item() <= ATOL
    assert bool(empty.any()) and bool((out[:, empty] == 0).all())


@pytest.mark.cuda
def test_clustered_flash_unbatched_and_odd_width(gen):
    """[N, h, c] inputs, c = 6 (not a multiple of 4: the scalar copies), and
    96-row blocks (not a multiple of the query tile)."""
    q, k, v, ids, masks, block, empty = _cluster_case(gen, 1, 300, 2, 6, 96, seed=1)
    with torch.no_grad():
        out = clustered_flash.clustered_flash_attention(q[0], k[0], v[0], ids, masks, block)
        ref = clustered_flash.clustered_flash_forward_reference(q[0], k[0], v[0], ids, masks, block)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= ATOL
    assert bool((out[empty] == 0).all())


def _symmetric_case(gen, b, n, heads, c, block, seed=0):
    """A symmetric random graph (every edge in both directions) on an odd
    number of nodes; node 5 has no edge at all, so its gradients are 0."""
    rng = np.random.default_rng(seed)
    receivers = np.repeat(np.arange(n), 4)
    senders = (receivers + rng.integers(-40, 41, receivers.size)) % n
    keep = (senders != 5) & (receivers != 5)
    pairs = np.unique(
        np.stack([np.r_[senders[keep], receivers[keep]], np.r_[receivers[keep], senders[keep]]], 1),
        axis=0,
    )
    assert is_symmetric_edges(pairs[:, 0], pairs[:, 1])
    layout = build_cluster_layout(pairs[:, 0], pairs[:, 1], n, n, block=block)
    ids = torch.as_tensor(layout.gather_ids, device="cuda")
    masks = torch.as_tensor(layout.masks.astype(np.int8), device="cuda")
    q, k, v, dout = (torch.randn(b, n, heads, c, generator=gen, device="cuda") for _ in range(4))
    return q, k, v, dout, ids, masks, block


def _plain_backward(q, k, v, ids, masks, block, dout, symmetric):
    out, lse = clustered_flash.clustered_flash_forward_reference(q, k, v, ids, masks, block, with_lse=True)
    return clustered_flash.clustered_flash_backward_reference(
        q, k, v, ids, masks, out, lse, dout, block, symmetric
    )


def _kernel_backward(q, k, v, ids, masks, block, dout, symmetric):
    """K3a with lse, then K3c (symmetric) or K3b, through the autograd Function.
    K3b gets its inverse index as DeviceGraph builds it."""
    scatter = None
    if not symmetric:
        index = build_cluster_scatter_index(ids.cpu().numpy(), masks.cpu().numpy(), k.shape[-3])
        scatter = torch.as_tensor(index, device="cuda")
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = clustered_flash.clustered_flash_attention(
        q, k, v, ids, masks, block, symmetric=symmetric, scatter_index=scatter
    )
    return torch.autograd.grad(out, (q, k, v), dout)


def _max_err(got, want):
    return max((a - b).abs().max().item() for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 128, 512])
def test_clustered_flash_lse_matches_plain(gen, c):
    """K3a's log-sum-exp output against the plain version's, empty rows included."""
    q, k, v, ids, masks, block, _ = _cluster_case(gen, 2, 700, 4, c, 256)
    out, lse = clustered_flash._forward_cuda(q, k, v, ids, masks, block, with_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = clustered_flash.clustered_flash_forward_reference(q, k, v, ids, masks, block, with_lse=True)
    assert lse.shape == ref_lse.shape == (2, ids.shape[0] * block, 4)
    assert (out - ref).abs().max().item() <= ATOL
    # Rows without a neighbour: -1e28 + log(1e-30), the same f32 in both.
    assert bool((ref_lse < -1e27).any())
    assert (lse - ref_lse).abs().max().item() <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("c", [32, 128, 512])
def test_backward_kernels_match_plain(gen, c, batch):
    """K3c and K3b each against the plain backward, and against each other,
    on a symmetric layout with odd n (padded rows in the last block), B in
    {1, 2}; exact zeros for the node without an edge."""
    q, k, v, dout, ids, masks, block = _symmetric_case(gen, batch, 701, 4, c, 256)
    want = _plain_backward(q, k, v, ids, masks, block, dout, symmetric=False)
    counts = (clustered_flash.SYMMETRIC_DQ_LAUNCHES, clustered_flash.SYMMETRIC_DKV_LAUNCHES,
              clustered_flash.GENERAL_BWD_LAUNCHES)
    sym = _kernel_backward(q, k, v, ids, masks, block, dout, symmetric=True)
    gen_ = _kernel_backward(q, k, v, ids, masks, block, dout, symmetric=False)
    torch.cuda.synchronize()
    assert (clustered_flash.SYMMETRIC_DQ_LAUNCHES, clustered_flash.SYMMETRIC_DKV_LAUNCHES,
            clustered_flash.GENERAL_BWD_LAUNCHES) == tuple(n + 1 for n in counts)
    assert _max_err(sym, want) <= ATOL
    assert _max_err(gen_, want) <= ATOL
    assert _max_err(sym, gen_) <= ATOL
    for grads in (sym, gen_):
        assert all(bool((t[:, 5] == 0).all()) for t in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 512])
def test_general_backward_on_directed_graph(gen, c):
    """K3b on a graph that is not symmetric, with empty receiver rows and a
    ragged last block: against the plain backward; empty rows' dq exactly 0."""
    q, k, v, ids, masks, block, empty = _cluster_case(gen, 2, 700, 4, c, 256)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    got = _kernel_backward(q, k, v, ids, masks, block, dout, symmetric=False)
    want = _plain_backward(q, k, v, ids, masks, block, dout, symmetric=False)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= ATOL
    assert bool((got[0][:, empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [False, True])
def test_backward_unbatched_odd_width(gen, symmetric):
    """[N, h, c] inputs, c = 6 (the scalar copies), 96-row blocks (not a
    multiple of the tiles)."""
    q, k, v, dout, ids, masks, block = _symmetric_case(gen, 1, 301, 2, 6, 96, seed=1)
    args = (q[0], k[0], v[0], ids, masks, block, dout[0])
    assert _max_err(_kernel_backward(*args, symmetric), _plain_backward(*args, symmetric)) <= ATOL


@pytest.mark.cuda
def test_clustered_flash_gradients_flow(gen):
    """Gradients flow through the autograd Function on the card: K3a with
    lse then K3c, agreeing with autograd of the plain forward (float64 on
    the CPU as the yardstick, gradcheck-style)."""
    q, k, v, dout, ids, masks, block = _symmetric_case(gen, 2, 301, 2, 32, 128, seed=2)
    before = clustered_flash.LAUNCHES
    got = _kernel_backward(q, k, v, ids, masks, block, dout, symmetric=True)
    assert clustered_flash.LAUNCHES == before + 1
    q64, k64, v64 = (t.detach().cpu().double().requires_grad_(True) for t in (q, k, v))
    out = clustered_flash.clustered_flash_forward_reference(q64, k64, v64, ids.cpu(), masks.cpu(), block)
    want = torch.autograd.grad(out, (q64, k64, v64), dout.cpu().double())
    assert max((a.cpu().double() - b).abs().max().item() for a, b in zip(got, want)) <= ATOL
    with pytest.raises(ValueError, match="same node set"):
        clustered_flash.clustered_flash_attention(q, k[:, :300], v[:, :300], ids, masks, block, symmetric=True)
    # K3b on the card never rebuilds its inverse index on the host.
    with pytest.raises(ValueError, match="scatter_index"):
        clustered_flash.clustered_flash_attention(q.requires_grad_(True), k, v, ids, masks, block)



@pytest.mark.cuda
@pytest.mark.parametrize("c", [20, 32, 128, 192, 512])
def test_clustered_tensor_core_tiles(gen, c):
    """K3a with lse, K3c and K3b against their plain versions at each tile
    width of the split-TF32 kernels: c = 20 (zero-padded to 24 in shared
    memory), 32, 128, 192 (FGN's heads: two warps share a row group) and
    512 (four); B = 2, a ragged last block (701 rows in 256-row blocks),
    exact zeros for the node without an edge."""
    q, k, v, dout, ids, masks, block = _symmetric_case(gen, 2, 701, 4, c, 256, seed=c)
    out, lse = clustered_flash._forward_cuda(q, k, v, ids, masks, block, with_lse=True)
    ref, ref_lse = clustered_flash.clustered_flash_forward_reference(
        q, k, v, ids, masks, block, with_lse=True
    )
    want = _plain_backward(q, k, v, ids, masks, block, dout, symmetric=False)
    sym = _kernel_backward(q, k, v, ids, masks, block, dout, symmetric=True)
    general = _kernel_backward(q, k, v, ids, masks, block, dout, symmetric=False)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= ATOL
    assert (lse - ref_lse).abs().max().item() <= ATOL
    assert _max_err(sym, want) <= ATOL and _max_err(general, want) <= ATOL
    assert bool((out[:, 5] == 0).all())
    for grads in (sym, general):
        assert all(bool((t[:, 5] == 0).all()) for t in grads)


def _last_subtile_case(gen, c, symmetric):
    """272 nodes in 128-row blocks (the last block ragged: 16 rows). Rows
    16-31 of block 0, one warp's row group, hold a single edge: row 16 from
    node 271, the largest id of block 0's union of 256 = U_pad, so the edge
    sits in the last 8-key sub-tile of the last key tile. Rows 17-31 have
    none; no other edge touches nodes 16-31."""
    rng = np.random.default_rng(3)
    n = 272
    pool = np.r_[0:16, 32:271]  # every sender but 16-31 and 271
    rows0 = np.r_[0:16, 32:128]
    receivers = [np.repeat(rows0, 6), [16], np.repeat(np.arange(128, n), 6)]
    senders0 = rng.choice(pool, 6 * rows0.size)
    senders0[: pool.size] = rng.permutation(pool)  # the union holds every node of the pool
    senders = [senders0, [271], rng.choice(pool, 6 * (n - 128))]
    r, s = np.concatenate(receivers), np.concatenate(senders)
    if symmetric:
        pairs = np.unique(np.stack([np.r_[s, r], np.r_[r, s]], 1), axis=0)
        s, r = pairs[:, 0], pairs[:, 1]
        assert is_symmetric_edges(s, r)
    order = np.argsort(r, kind="stable")
    layout = build_cluster_layout(s[order], r[order], n, n, block=128)
    assert layout.u_pad == 256 and layout.gather_ids[0, 255] == 271
    assert layout.masks[0, 16:32].sum() == 1 and layout.masks[0, 16, 255]
    ids = torch.as_tensor(layout.gather_ids, device="cuda")
    masks = torch.as_tensor(layout.masks.astype(np.int8), device="cuda")
    q, k, v, dout = (torch.randn(1, n, 2, c, generator=gen, device="cuda") for _ in range(4))
    return q, k, v, dout, ids, masks, 128


@pytest.mark.cuda
@pytest.mark.parametrize("c", [20, 128, 512])
def test_clustered_warp_with_one_edge_in_the_last_subtile(gen, c):
    """A warp whose only edge lies in the last key sub-tile: K3a gives row 16
    node 271's value and rows 17-31 exact zeros; K3a, K3c and K3b against
    their plain versions."""
    for symmetric in (False, True):
        q, k, v, dout, ids, masks, block = _last_subtile_case(gen, c, symmetric)
        with torch.no_grad():
            out = clustered_flash.clustered_flash_attention(q, k, v, ids, masks, block)
            ref = clustered_flash.clustered_flash_forward_reference(q, k, v, ids, masks, block)
        got = _kernel_backward(q, k, v, ids, masks, block, dout, symmetric)
        want = _plain_backward(q, k, v, ids, masks, block, dout, symmetric)
        torch.cuda.synchronize()
        assert (out - ref).abs().max().item() <= ATOL
        assert (out[0, 16] - v[0, 271]).abs().max().item() <= ATOL
        assert bool((out[:, 17:32] == 0).all())
        assert _max_err(got, want) <= ATOL
        assert all(bool((t[:, 17:32] == 0).all()) for t in got)

# -- K3a, K3b and K3c in bf16 -------------------------------------------------

# Two bf16 ulps (8 significant bits) of the tensor's largest value: the
# kernels and the plain versions round p, ds and the outputs to bf16 at the
# same points, but sum in f32 in another order, and the kernels round p
# against the running max, so some elements round to the neighbouring value.
BF16_TOL = 2.0**-6


def _bf16_err(got, want):
    """max |got - want| over BF16_TOL max |want|: within the rule when <= 1."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() / (BF16_TOL * want.abs().max().item())


def _k3_counts():
    return tuple(getattr(clustered_flash, name) for name in (
        "LAUNCHES", "GENERAL_BWD_LAUNCHES", "SYMMETRIC_DQ_LAUNCHES", "SYMMETRIC_DKV_LAUNCHES",
        "BF16_LAUNCHES", "BF16_GENERAL_BWD_LAUNCHES", "BF16_SYMMETRIC_DQ_LAUNCHES",
        "BF16_SYMMETRIC_DKV_LAUNCHES"))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("c", [20, 32, 128, 192, 512])
def test_clustered_flash_bf16_matches_plain(gen, c, batch):
    """K3a in bf16 (with and without lse), K3c and K3b in bf16 against their
    plain versions on bf16 inputs, at each tile width (c = 20: the 2-byte
    copies, zeros to 32; 192 and 512: warps that share a row group), B in
    {1, 2}, a ragged last block: out, dq, dk and dv bf16 within 2 ulps of
    their max, lse within ATOL, exact zeros for the node without an edge;
    the bf16 launch counts move, the f32 ones do not."""
    q, k, v, dout, ids, masks, block = _symmetric_case(gen, batch, 701, 4, c, 256, seed=c)
    q, k, v, dout = (t.bfloat16() for t in (q, k, v, dout))
    before = _k3_counts()
    with torch.no_grad():
        out = clustered_flash.clustered_flash_attention(q, k, v, ids, masks, block)
    out_l, lse = clustered_flash._forward_cuda(q, k, v, ids, masks, block, with_lse=True)
    sym = _kernel_backward(q, k, v, ids, masks, block, dout, symmetric=True)
    general = _kernel_backward(q, k, v, ids, masks, block, dout, symmetric=False)
    torch.cuda.synchronize()
    made = tuple(a - b for a, b in zip(_k3_counts(), before))
    assert made == (0, 0, 0, 0, 4, 1, 1, 1)
    ref, ref_lse = clustered_flash.clustered_flash_forward_reference(
        q, k, v, ids, masks, block, with_lse=True
    )
    want = _plain_backward(q, k, v, ids, masks, block, dout, symmetric=False)
    assert out.dtype == out_l.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _bf16_err(out, ref) <= 1 and _bf16_err(out_l, ref) <= 1
    assert (lse - ref_lse).abs().max().item() <= ATOL
    for grads in (sym, general):
        assert all(g.dtype == torch.bfloat16 for g in grads)
        assert max(_bf16_err(a, b) for a, b in zip(grads, want)) <= 1
        assert all(bool((t[:, 5] == 0).all()) for t in grads)
    assert bool((out[:, 5] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", [192, 766, 768])
def test_clustered_fgn_widths_match_plain(gen, c, dtype):
    """K3a (with and without lse) and K3c at FGN's head widths: c = 192 (its
    23 blocks, on the W256 tile) and 768 (its last block, on W768: one copy
    stage in f32, two in bf16), and 766 (W768 with zeros past c and the
    scalar copies), B = 2, a symmetric layout with a ragged last block:
    against the plain versions (f32 within ATOL; bf16 within two ulps of
    the max, lse ATOL), exact zeros for the node without an edge, bit-equal
    over two launches, the launch counts of the dtype move; K3b's general
    backward refuses c > 512 before any launch."""
    q, k, v, dout, ids, masks, block = _symmetric_case(gen, 2, 701, 2, c, 256, seed=c)
    if dtype == "bf16":
        q, k, v, dout = (t.bfloat16() for t in (q, k, v, dout))
    before = _k3_counts()
    with torch.no_grad():
        out = clustered_flash.clustered_flash_attention(q, k, v, ids, masks, block)
    out_l, lse = clustered_flash._forward_cuda(q, k, v, ids, masks, block, with_lse=True)
    args = (q, k, v, ids, masks, out_l, lse, dout, block)
    grads = clustered_flash._backward_cuda(*args, True, None)
    again = clustered_flash._backward_cuda(*args, True, None)
    torch.cuda.synchronize()
    made = tuple(a - b for a, b in zip(_k3_counts(), before))
    assert made == ((2, 0, 2, 2, 0, 0, 0, 0) if dtype == "f32" else (0, 0, 0, 0, 2, 0, 2, 2))
    ref, ref_lse = clustered_flash.clustered_flash_forward_reference(q, k, v, ids, masks, block,
                                                                     with_lse=True)
    want = clustered_flash.clustered_flash_backward_reference(*args, symmetric=True)
    for got, wanted in ((out, ref), (out_l, ref), *zip(grads, want)):
        assert got.dtype == q.dtype and got.shape == wanted.shape
        if dtype == "f32":
            assert (got - wanted).abs().max().item() <= ATOL
        else:
            assert _bf16_err(got, wanted) <= 1.0
    assert (lse - ref_lse).abs().max().item() <= ATOL
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert all(bool((t[:, 5] == 0).all()) for t in (out, *grads))
    scatter = torch.zeros(701, 1, dtype=torch.int64, device="cuda")
    if c > 512:
        with pytest.raises(ValueError, match="§2 item 4"):
            clustered_flash._backward_cuda(*args, False, scatter)
    assert _k3_counts()[1] == before[1] and _k3_counts()[5] == before[5]


def _sparse_symmetric_case(gen, c, n=1301, degree=64, span=300, heads=2):
    """A symmetric random graph about as sparse as FGN's k-hop layout
    (blocks of 256 rows, U_pad 896, 10.9% of the mask set; FGN: 1,024,
    12.2%), bf16 rows; node 5 has no edge."""
    rng = np.random.default_rng(c)
    receivers = np.repeat(np.arange(n), degree)
    senders = (receivers + rng.integers(-span, span + 1, receivers.size)) % n
    keep = (senders != 5) & (receivers != 5)
    pairs = np.unique(np.stack([np.r_[senders[keep], receivers[keep]],
                                np.r_[receivers[keep], senders[keep]]], 1), axis=0)
    layout = build_cluster_layout(pairs[:, 0], pairs[:, 1], n, n, block=256)
    ids = torch.as_tensor(layout.gather_ids, device="cuda")
    masks = torch.as_tensor(layout.masks.astype(np.int8), device="cuda")
    q, k, v, dout = (torch.randn(1, n, heads, c, generator=gen, device="cuda").bfloat16()
                     for _ in range(4))
    return q, k, v, dout, ids, masks, 256


@pytest.mark.cuda
@pytest.mark.parametrize("c", [136, 192, 256])
def test_clustered_bf16_mid_tiles_match_plain(gen, c):
    """K3c in bf16 at 128 < c <= 256 (its M192 tile up to 192: FGN's c =
    192, zeros past c at 136; W256 at 256) on a layout as sparse as FGN's:
    dq, dk and dv within two bf16 ulps of the plain version's max, exact
    zeros for the node without an edge, bit-equal over two launches; one
    launch of each kernel on the M192 tile's counters (none at 256), none on
    the f32 or K3b ones."""
    q, k, v, dout, ids, masks, block = _sparse_symmetric_case(gen, c)
    mid = c <= 192
    assert clustered_flash.backward_tile(c, torch.bfloat16, True) == ("M192" if mid else "W256")
    out, lse = clustered_flash._forward_cuda(q, k, v, ids, masks, block, with_lse=True)
    args = (q, k, v, ids, masks, out, lse, dout, block)
    names = ("BF16_MID_SYMMETRIC_DQ_LAUNCHES", "BF16_MID_SYMMETRIC_DKV_LAUNCHES",
             "BF16_SYMMETRIC_DQ_LAUNCHES", "SYMMETRIC_DQ_LAUNCHES", "BF16_GENERAL_BWD_LAUNCHES")
    before = [getattr(clustered_flash, n) for n in names]
    got = clustered_flash._backward_cuda(*args, True, None)
    again = clustered_flash._backward_cuda(*args, True, None)
    torch.cuda.synchronize()
    assert [getattr(clustered_flash, n) - b for n, b in zip(names, before)] == [2 * mid, 2 * mid, 2, 0, 0]
    want = clustered_flash.clustered_flash_backward_reference(*args, symmetric=True)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and _bf16_err(a, b) <= 1.0
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool((t[:, 5] == 0).all()) for t in got)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 7, 768])
@pytest.mark.parametrize("batch", [1, 3])
def test_segment_sum_f32_matches_plain(gen, width, batch):
    """S in f32 against its plain version, bit for bit, over unsorted ids
    with empty nodes and one node of 600 edges; a second launch repeats its
    bits; within f32 rounding of index_add_; the f32 count moves."""
    rng = np.random.default_rng(width + batch)
    ids = np.concatenate([rng.integers(0, 90, 2000), np.full(600, 17)]).astype(np.int32)
    ids = rng.permutation(ids[ids % 11 != 3])
    offsets, edge_ids = (torch.as_tensor(a, device="cuda") for a in build_flat_csr(ids, 90))
    rows = torch.randn(batch, ids.size, width, generator=gen, device="cuda")
    before = scatter.F32_LAUNCHES, scatter.LAUNCHES
    got = scatter.edge_order_sum(rows, offsets, edge_ids)
    again = scatter.edge_order_sum(rows, offsets, edge_ids)
    torch.cuda.synchronize()
    assert (scatter.F32_LAUNCHES, scatter.LAUNCHES) == (before[0] + 2, before[1])
    want = scatter.edge_order_sum_reference(rows, offsets, edge_ids)
    assert got.dtype == torch.float32 and torch.equal(got, want) and torch.equal(got, again)
    index = torch.as_tensor(ids, device="cuda").long()
    atomics = torch.zeros_like(got).index_add_(1, index, rows)
    assert (got - atomics).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [False, True])
def test_clustered_flash_bf16_unbatched_odd_width(gen, symmetric):
    """[N, h, c] bf16 inputs, c = 6 (the 2-byte copies and stores), 96-row
    blocks: the forward and the backward against their plain versions."""
    q, k, v, dout, ids, masks, block = _symmetric_case(gen, 1, 301, 2, 6, 96, seed=1)
    args = [t[0].bfloat16() for t in (q, k, v)] + [ids, masks, block]
    with torch.no_grad():
        out = clustered_flash.clustered_flash_attention(*args)
    assert _bf16_err(out, clustered_flash.clustered_flash_forward_reference(*args)) <= 1
    got = _kernel_backward(*args, dout[0].bfloat16(), symmetric)
    want = _plain_backward(*args, dout[0].bfloat16(), symmetric)
    assert max(_bf16_err(a, b) for a, b in zip(got, want)) <= 1


@pytest.mark.cuda
def test_clustered_flash_bf16_refuses_mixed_dtypes(gen):
    q, k, v, _, ids, masks, block = _symmetric_case(gen, 1, 301, 2, 32, 128)
    with pytest.raises(TypeError, match="all bfloat16"):
        clustered_flash.clustered_flash_attention(q.bfloat16(), k, v, ids, masks, block)


# -- K5a / K5b: 3D neighborhood attention -------------------------------------

NATTEN_CASES = [
    # (B, D, H, W), heads, ch, kernel, rpb, circular_w
    ((2, 4, 7, 9), 2, 4, (3, 3, 3), True, False),
    ((2, 4, 7, 9), 2, 6, (3, 5, 5), True, True),  # ch % 4 != 0: the scalar copies
    ((1, 3, 6, 8), 4, 32, (3, 3, 5), False, True),
    ((1, 5, 9, 10), 2, 64, (5, 7, 7), True, False),
    ((1, 3, 5, 12), 1, 100, (3, 3, 5), True, True),
    ((1, 14, 45, 90), 4, 32, (3, 5, 5), True, False),  # WeatherMesh's 1-degree latent
]
NATTEN_IDS = ["tiny", "odd_ch_circular", "hc128_no_rpb", "k577_ch64", "ch100", "wm_1deg"]


def _natten_inputs(gen, shape, heads, ch, kernel, with_rpb, fused=False):
    """q, k, v (views of one fused [.., 3 * heads * ch] tensor when `fused`,
    as the model's qkv projection gives them), rpb ~N(0, 0.5^2) or None."""
    if fused:
        qkv = torch.randn(*shape, 3 * heads * ch, generator=gen, device="cuda")
        q, k, v = (t.reshape(*shape, heads, ch) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn(*shape, heads, ch, generator=gen, device="cuda") for _ in range(3))
    rpb = None
    if with_rpb:
        rpb = 0.5 * torch.randn(heads, *(2 * kk - 1 for kk in kernel), generator=gen, device="cuda")
    return q, k, v, rpb


@pytest.mark.cuda
@pytest.mark.parametrize("case", NATTEN_CASES, ids=NATTEN_IDS)
def test_natten_forward_matches_plain(gen, case):
    """K5a's out and lse against the plain version."""
    shape, heads, ch, kernel, with_rpb, circular = case
    q, k, v, rpb = _natten_inputs(gen, shape, heads, ch, kernel, with_rpb, fused=ch == 32)
    before = natten_flash.LAUNCHES
    out, lse = natten_flash._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True)
    torch.cuda.synchronize()
    assert natten_flash.LAUNCHES == before + 1
    ref, ref_lse = neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular, with_lse=True)
    assert out.shape == q.shape and lse.shape == q.shape[:-1]
    assert (out - ref).abs().max().item() <= ATOL
    assert (lse - ref_lse).abs().max().item() <= ATOL
    with torch.no_grad():
        served = neighborhood_attention_3d(q, k, v, kernel, rpb, circular)
    assert torch.equal(served, out)


K5A_PLAN_CASES = [
    # (B, D, H, W), heads, ch, kernel, circular_w
    ((1, 14, 45, 90), 8, 32, (5, 7, 7), False),  # phase 18's case c: four query planes a CTA
    ((1, 14, 45, 90), 4, 128, (3, 5, 5), False),  # the widest head K5a takes: 16 lanes a group
    ((2, 7, 11, 21), 2, 32, (3, 5, 5), True),  # tiles cut at every edge, the circular seam
    ((2, 5, 9, 19), 3, 64, (5, 7, 7), True),
    ((1, 5, 9, 37), 2, 16, (3, 3, 5), False),  # 4 lanes a group, 32-column tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K5A_PLAN_CASES,
                         ids=["k577_1deg", "ch128_1deg", "edges_circular_b2", "k577_ch64_circular_b2",
                              "ch16"])
def test_natten_forward_plans(gen, case):
    """K5a on the plans of `_fwd_plan` (whole slabs in two stages, lane
    groups of four queries) against the plain version, out and lse; both
    repeat bit for bit over two launches."""
    shape, heads, ch, kernel, circular = case
    q, k, v, rpb = _natten_inputs(gen, shape, heads, ch, kernel, True, fused=True)
    before = natten_flash.LAUNCHES
    out, lse = natten_flash._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True)
    out2, lse2 = natten_flash._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True)
    torch.cuda.synchronize()
    assert natten_flash.LAUNCHES == before + 2
    ref, ref_lse = neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular, with_lse=True)
    assert (out - ref).abs().max().item() <= ATOL
    assert (lse - ref_lse).abs().max().item() <= ATOL
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(1, 8, 3, 7), (4, 2, 2, 20), (8, 1, 5, 5), (2, 4, 1, 1)],
                         ids=["strips_1x8", "strips_4x2", "strips_8x1", "one_position"])
def test_natten_forward_slab_strips(gen, monkeypatch, rows):
    """K5a with its slabs cut into items of ry rows by rx columns (what
    `_fwd_plan` picks where a whole slab does not fit), and each split of
    the CTA's eight rows into query planes and rows, against the plain
    version."""
    shape, heads, ch, kernel, circular = (1, 6, 11, 21), 2, 32, (3, 5, 5), True
    q, k, v, rpb = _natten_inputs(gen, shape, heads, ch, kernel, True, fused=True)
    plan = natten_flash._fwd_plan(shape[1:], kernel, circular, ch, True)
    td, th, ry, rx = rows
    monkeypatch.setattr(natten_flash, "_fwd_plan",
                        lambda *args: dataclasses.replace(plan, td=td, th=th, ry=ry, rx=rx))
    out, lse = natten_flash._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular, with_lse=True)
    assert (out - ref).abs().max().item() <= ATOL
    assert (lse - ref_lse).abs().max().item() <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", NATTEN_CASES, ids=NATTEN_IDS)
def test_natten_backward_matches_plain(gen, case):
    """K5b (through the autograd Function: K5a with lse, then the dq and
    dk/dv kernels) against the plain backward: dq, dk, dv within 1e-4, drpb
    within 1e-4 of its max."""
    shape, heads, ch, kernel, with_rpb, circular = case
    q, k, v, rpb = _natten_inputs(gen, shape, heads, ch, kernel, with_rpb, fused=ch == 32)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v) + ((rpb,) if with_rpb else ())]
    counts = (natten_flash.BWD_DQ_LAUNCHES, natten_flash.BWD_DKV_LAUNCHES)
    out = neighborhood_attention_3d(
        *leaves[:3], kernel, leaves[3] if with_rpb else None, circular
    )
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (natten_flash.BWD_DQ_LAUNCHES, natten_flash.BWD_DKV_LAUNCHES) == (counts[0] + 1, counts[1] + 1)
    ref_out, lse = neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular, with_lse=True)
    want = natten_flash.natten_flash_backward_reference(q, k, v, rpb, ref_out, lse, dout, kernel, circular)
    for name, a, b in zip("q k v".split(), got[:3], want[:3]):
        assert (a - b).abs().max().item() <= ATOL, f"d{name}"
    if with_rpb:
        assert (got[3] - want[3]).abs().max().item() <= ATOL * want[3].abs().max().item()


K5B_TILE_CASES = [
    # (B, D, H, W), heads, ch, kernel, circular_w
    ((1, 5, 9, 11), 2, 32, (3, 3, 5), False),  # W past the last group of four
    ((2, 5, 9, 11), 2, 32, (3, 3, 5), True),  # the circular seam
    ((1, 6, 9, 14), 8, 32, (5, 7, 7), False),  # clamped windows at every edge
    ((1, 6, 9, 14), 2, 64, (5, 7, 7), True),
    ((1, 1, 2, 120), 1, 128, (1, 1, 71), False),  # no staged row fits: queries through L1
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K5B_TILE_CASES,
                         ids=["k335", "k335_circular_b2", "k577", "k577_ch64_circular", "unstaged"])
def test_natten_backward_kernels_apart(gen, case):
    """K5b's dq kernel (with its drpb partials) and dk/dv kernel, each
    launched alone through `launch_backward`, against the plain backward,
    with one launch counted for each."""
    shape, heads, ch, kernel, circular = case
    q, k, v, rpb = _natten_inputs(gen, shape, heads, ch, kernel, True, fused=ch == 32)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    out, lse = neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular, with_lse=True)
    want = natten_flash.natten_flash_backward_reference(q, k, v, rpb, out, lse, dout, kernel, circular)
    delta = (dout * out).sum(-1).contiguous()
    grads = tuple(torch.full_like(q, float("nan")) for _ in range(3))
    tile = natten_flash._pick_tile("dq", tuple(shape[1:]), kernel, circular, ch, True)
    partial = torch.empty(shape[0] * tile.n_tiles, heads, rpb[0].numel(), device="cuda")
    counts = (natten_flash.BWD_DQ_LAUNCHES, natten_flash.BWD_DKV_LAUNCHES)
    natten_flash.launch_backward(natten_flash.DQ, q, k, v, rpb, dout, lse, delta, grads, partial,
                                 kernel, circular)
    torch.cuda.synchronize()
    assert (natten_flash.BWD_DQ_LAUNCHES, natten_flash.BWD_DKV_LAUNCHES) == (counts[0] + 1, counts[1])
    assert (grads[0] - want[0]).abs().max().item() <= ATOL
    assert torch.isnan(grads[1]).all() and torch.isnan(grads[2]).all()  # dq mode writes dq only
    drpb = partial.sum(0).reshape(rpb.shape)
    assert (drpb - want[3]).abs().max().item() <= ATOL * want[3].abs().max().item()
    natten_flash.launch_backward(natten_flash.DKV, q, k, v, rpb, dout, lse, delta, grads, None,
                                 kernel, circular)
    torch.cuda.synchronize()
    assert (natten_flash.BWD_DQ_LAUNCHES, natten_flash.BWD_DKV_LAUNCHES) == (counts[0] + 1, counts[1] + 1)
    for name, a, b in zip("kv", grads[1:], want[1:3]):
        assert (a - b).abs().max().item() <= ATOL, f"d{name}"


@pytest.mark.cuda
def test_natten_plain_backward_is_autograd_of_the_twin(gen):
    """The plain backward against autograd through the plain forward, in
    float64 on the CPU (the yardstick of K5b's oracle)."""
    q, k, v, rpb = _natten_inputs(gen, (1, 4, 6, 8), 2, 8, (3, 3, 5), True)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    out, lse = neighborhood_attention_3d_reference(q, k, v, (3, 3, 5), rpb, True, with_lse=True)
    got = natten_flash.natten_flash_backward_reference(q, k, v, rpb, out, lse, dout, (3, 3, 5), True)
    leaves = [t.detach().cpu().double().requires_grad_(True) for t in (q, k, v, rpb)]
    out64 = neighborhood_attention_3d_reference(*leaves[:3], (3, 3, 5), leaves[3], True)
    want = torch.autograd.grad(out64, leaves, dout.cpu().double())
    assert max((a.cpu().double() - b).abs().max().item() for a, b in zip(got, want)) <= ATOL


@pytest.mark.cuda
def test_natten_refuses_what_it_cannot_take(gen):
    """impl="flash" (K5a alone) raises for the shapes K5a cannot tile, where
    "auto" would take K6; no kernel takes [heads, ch] rows that are not
    dense."""
    q, k, v, rpb = _natten_inputs(gen, (1, 5, 9, 10), 1, 129, (3, 3, 3), True)
    with pytest.raises(ValueError, match="head width"):
        neighborhood_attention_3d(q, k, v, (3, 3, 3), rpb, impl="flash")
    q, k, v, rpb = _natten_inputs(gen, (1, 14, 45, 90), 1, 128, (5, 7, 7), True)
    with pytest.raises(ValueError, match="shared memory"):
        neighborhood_attention_3d(q, k, v, (5, 7, 7), rpb, impl="flash")
    q, k, v, rpb = _natten_inputs(gen, (1, 5, 9, 10), 2, 8, (3, 3, 3), True)
    strided = q.transpose(-1, -2).contiguous().transpose(-1, -2)  # [heads, ch] not dense
    for impl in ("flash", "pallas"):
        with pytest.raises(ValueError, match="dense"):
            neighborhood_attention_3d(strided, k, v, (3, 3, 3), rpb, impl=impl)


# -- K5a and K5b in bf16 ----------------------------------------------------------

NATTEN_BF16_CASES = [
    # (B, D, H, W), heads, ch, kernel, rpb, circular_w
    ((1, 14, 45, 90), 4, 32, (3, 5, 5), True, False),  # the 128-d WeatherMesh's layers
    ((2, 5, 9, 11), 2, 32, (3, 3, 5), True, True),  # the circular seam, two batch entries
    ((1, 6, 9, 14), 8, 32, (5, 7, 7), True, False),  # clamped windows at every edge
    ((2, 4, 7, 9), 3, 12, (3, 3, 3), False, False),  # ch % 8 != 0: element loads
    # the dk/dv kernel's key tiles (1 x 8) end inside the TPU tiles (12 x 6)
    ((1, 4, 15, 26), 4, 32, (3, 5, 5), True, False),
    # circular: TPU tiles of 16 columns on W = 22, a key's parts across the seam
    ((2, 3, 8, 22), 4, 32, (3, 3, 7), True, True),
    # no TPU tile fits (tpu_backward_tile is None): one part, rounded once
    ((1, 8, 16, 24), 8, 16, (3, 7, 7), True, False),
]
NATTEN_BF16_IDS = ["wm_1deg", "circular_b2", "k577", "ch12_no_rpb", "tiles_inside", "circular_seam",
                   "no_tpu_tile"]


def _bf16_inputs(gen, shape, heads, ch, kernel, with_rpb):
    q, k, v, rpb = _natten_inputs(gen, shape, heads, ch, kernel, with_rpb, fused=ch % 8 == 0)
    return tuple(None if t is None else t.bfloat16() for t in (q, k, v, rpb))


@pytest.mark.cuda
@pytest.mark.parametrize("case", NATTEN_BF16_CASES, ids=NATTEN_BF16_IDS)
def test_natten_bf16_forward_matches_plain(gen, case):
    """K5a's bf16 mode against its plain version (the TPU kernel's
    roundings): out within two bf16 ulps of its max, lse within 1e-4; one
    bf16 launch a call, bit-equal over two."""
    shape, heads, ch, kernel, with_rpb, circular = case
    q, k, v, rpb = _bf16_inputs(gen, shape, heads, ch, kernel, with_rpb)
    before = (natten_flash.LAUNCHES, natten_flash.BF16_LAUNCHES)
    out, lse = natten_flash._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True)
    out2, lse2 = natten_flash._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True)
    torch.cuda.synchronize()
    assert (natten_flash.LAUNCHES, natten_flash.BF16_LAUNCHES) == (before[0], before[1] + 2)
    ref, ref_lse = natten_flash.flash_forward_reference(q, k, v, kernel, rpb, circular, with_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _bf16_err(out, ref) <= 1
    assert (lse - ref_lse).abs().max().item() <= ATOL
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", NATTEN_BF16_CASES, ids=NATTEN_BF16_IDS)
def test_natten_bf16_backward_matches_plain(gen, case):
    """K5b's bf16 mode through the dispatcher's autograd path (K5a with lse,
    then the dq and dk/dv kernels) against the plain backward: every
    gradient within two bf16 ulps of its max; bit-equal over two backwards."""
    shape, heads, ch, kernel, with_rpb, circular = case
    q, k, v, rpb = _bf16_inputs(gen, shape, heads, ch, kernel, with_rpb)
    dout = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v) + ((rpb,) if with_rpb else ())]
    counts = (natten_flash.BF16_BWD_DQ_LAUNCHES, natten_flash.BF16_BWD_DKV_LAUNCHES,
              natten_flash.BWD_DQ_LAUNCHES)
    out = neighborhood_attention_3d(*leaves[:3], kernel, leaves[3] if with_rpb else None, circular)
    got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    again = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (natten_flash.BF16_BWD_DQ_LAUNCHES, natten_flash.BF16_BWD_DKV_LAUNCHES,
            natten_flash.BWD_DQ_LAUNCHES) == (counts[0] + 2, counts[1] + 2, counts[2])
    ref_out, lse = natten_flash.flash_forward_reference(q, k, v, kernel, rpb, circular, with_lse=True)
    want = natten_flash.natten_flash_backward_reference(q, k, v, rpb, ref_out, lse, dout, kernel,
                                                        circular)
    for name, a, b in zip(("dq", "dk", "dv", "drpb"), got, want):
        assert a.dtype == torch.bfloat16 and _bf16_err(a, b) <= 1, name
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [NATTEN_BF16_CASES[i] for i in (1, 4, 5, 6)],
                         ids=[NATTEN_BF16_IDS[i] for i in (1, 4, 5, 6)])
def test_natten_bf16_dkv_one_row_items(gen, case, monkeypatch):
    """K5b·bf16's dk/dv kernel on items of one row, its walk where a TPU
    tile of H's rows of the window do not fit in shared memory (each TPU
    tile of W's part then stays open over the tile of H's items): dk and dv
    within two bf16 ulps of the plain version's max, bit-equal over two
    launches."""
    shape, heads, ch, kernel, with_rpb, circular = case
    q, k, v, rpb = _bf16_inputs(gen, shape, heads, ch, kernel, with_rpb)
    dout = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    plan = natten_flash.dkv_bf16_plan(tuple(shape[1:]), kernel, circular, heads, ch, with_rpb)
    assert plan.ry > 1
    monkeypatch.setattr(natten_flash, "dkv_bf16_plan",
                        lambda *args: dataclasses.replace(plan, ry=1, whole=False))
    out, lse = natten_flash.flash_forward_reference(q, k, v, kernel, rpb, circular, with_lse=True)
    got = natten_flash._backward_cuda(q, k, v, rpb, out, lse, dout, kernel, circular)
    again = natten_flash._backward_cuda(q, k, v, rpb, out, lse, dout, kernel, circular)
    torch.cuda.synchronize()
    want = natten_flash.natten_flash_backward_reference(q, k, v, rpb, out, lse, dout, kernel, circular)
    for name, a, b in zip(("dk", "dv"), got[1:3], want[1:3]):
        assert a.dtype == torch.bfloat16 and _bf16_err(a, b) <= 1, name
    assert all(torch.equal(a, b) for a, b in zip(got[1:3], again[1:3]))


# -- K6: the wide-head 3D neighborhood attention forward -----------------------

K6_CASES = [
    # (B, D, H, W), heads, ch, kernel, rpb, circular_w
    ((1, 14, 45, 90), 8, 96, (5, 7, 7), True, False),  # the 768-d WeatherMesh's layers
    ((1, 14, 45, 90), 8, 96, (5, 7, 7), True, True),
    ((1, 14, 45, 90), 4, 32, (3, 5, 5), True, False),  # the 128-d WeatherMesh's layers
    ((1, 14, 45, 90), 2, 256, (3, 5, 5), True, False),
    ((2, 4, 7, 9), 3, 5, (3, 3, 3), True, True),  # ch % 4 != 0: the scalar loads
    ((2, 5, 6, 7), 2, 200, (5, 5, 7), False, True),
    ((1, 3, 5, 12), 1, 1, (3, 5, 12), True, False),  # the window covers H and W
    # 8 x 16 tiles whose last row of tiles straddles the clamped H edge and
    # whose last column straddles the circular seam (W = 21)
    ((1, 6, 13, 21), 2, 96, (5, 7, 7), True, True),
    ((2, 7, 11, 19), 3, 64, (5, 7, 7), True, False),  # clamped edges on every axis
    ((1, 5, 9, 18), 2, 128, (5, 7, 7), True, True),  # 16 lanes to a query group
]
K6_IDS = ["wide", "wide_circular", "wm_1deg", "ch256", "odd_ch_batch2", "ch200_no_rpb", "ch1",
          "seam_and_edge", "clamped_edges_batch2", "ch128_circular"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K6_CASES, ids=K6_IDS)
def test_natten3d_matches_plain(gen, case):
    """K6 against the plain version within 1e-4, one launch per call; the
    dispatcher's "pallas" and (where K5a cannot tile) "auto" take it."""
    shape, heads, ch, kernel, with_rpb, circular = case
    q, k, v, rpb = _natten_inputs(gen, shape, heads, ch, kernel, with_rpb, fused=ch % 4 == 0)
    before = natten3d.LAUNCHES
    out = natten3d.neighborhood_attention_3d_slot(q, k, v, kernel, rpb, circular)
    torch.cuda.synchronize()
    assert natten3d.LAUNCHES == before + 1
    ref = neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular)
    assert out.shape == q.shape
    assert (out - ref).abs().max().item() <= ATOL
    with torch.no_grad():
        assert torch.equal(neighborhood_attention_3d(q, k, v, kernel, rpb, circular, impl="pallas"), out)
        counts = (natten3d.LAUNCHES, natten_flash.LAUNCHES)
        neighborhood_attention_3d(q, k, v, kernel, rpb, circular)
        k5a = route(tuple(q.shape), kernel, circular, with_rpb, False) == "flash"
        assert k5a == (ch <= 64 or (ch <= 128 and kernel != (5, 7, 7)))
        assert (natten3d.LAUNCHES, natten_flash.LAUNCHES) == (counts[0] + (not k5a), counts[1] + k5a)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K6_CASES, ids=K6_IDS)
def test_natten3d_lse_matches_plain(gen, case):
    """K6's lse (written only when asked) against the plain version's, its
    out unchanged by it, and both bit-equal over two launches."""
    shape, heads, ch, kernel, with_rpb, circular = case
    q, k, v, rpb = _natten_inputs(gen, shape, heads, ch, kernel, with_rpb, fused=ch % 4 == 0)
    out, lse = natten3d._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True)
    out2, lse2 = natten3d._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True)
    served, none = natten3d._forward_cuda(q, k, v, kernel, rpb, circular)
    torch.cuda.synchronize()
    ref, ref_lse = neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular, with_lse=True)
    assert none is None and lse.shape == q.shape[:-1]
    assert (lse - ref_lse).abs().max().item() <= ATOL
    assert torch.equal(out, served) and torch.equal(out, out2) and torch.equal(lse, lse2)
    assert (out - ref).abs().max().item() <= ATOL


def _k6b_against_plain(gen, case):
    """K6b through the dispatcher's autograd path (K6 with lse, then the dq
    and dk/dv kernels, one launch each) against the plain backward: every
    gradient within 1e-4 of its tensor's max|g|; a second backward repeats
    its bits."""
    shape, heads, ch, kernel, with_rpb, circular = case
    q, k, v, rpb = _natten_inputs(gen, shape, heads, ch, kernel, with_rpb, fused=ch % 4 == 0)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v) + ((rpb,) if with_rpb else ())]
    counts = (natten3d.LAUNCHES, natten3d.BWD_DQ_LAUNCHES, natten3d.BWD_DKV_LAUNCHES,
              natten_flash.LAUNCHES, natten_flash.BWD_DQ_LAUNCHES)
    out = neighborhood_attention_3d(*leaves[:3], kernel, leaves[3] if with_rpb else None, circular,
                                    impl="pallas")
    got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    again = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (natten3d.LAUNCHES, natten3d.BWD_DQ_LAUNCHES, natten3d.BWD_DKV_LAUNCHES,
            natten_flash.LAUNCHES, natten_flash.BWD_DQ_LAUNCHES) == (
        counts[0] + 1, counts[1] + 2, counts[2] + 2, counts[3], counts[4])
    ref_out, lse = neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular, with_lse=True)
    want = natten_flash.natten_flash_backward_reference(q, k, v, rpb, ref_out, lse, dout, kernel,
                                                        circular)
    for name, a, b in zip(("dq", "dk", "dv", "drpb"), got, want):
        assert (a - b).abs().max().item() <= ATOL * b.abs().max().item(), name
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("case", K6_CASES, ids=K6_IDS)
def test_natten3d_backward_matches_plain(gen, case):
    _k6b_against_plain(gen, case)


@pytest.mark.cuda
@pytest.mark.parametrize("strips", [(1, None), (1, 3), (2, 5)], ids=["rows_1", "one_by_3", "two_by_5"])
@pytest.mark.parametrize("case", [K6_CASES[7], K6_CASES[5], K6_CASES[9]],
                         ids=["seam_and_edge", "ch200_no_rpb", "ch128_circular"])
def test_natten3d_backward_strips(gen, monkeypatch, case, strips):
    """K6b with both kernels' items cut into strips of ry rows by rx columns
    (rx None: the plan's), as `plan_backward` cuts them where a plane does
    not fit, against the plain backward."""
    ry, rx = strips
    plan_backward = natten3d.plan_backward
    monkeypatch.setattr(natten3d, "plan_backward", lambda *args: tuple(
        dataclasses.replace(p, ry=ry, rx=p.rx if rx is None else rx) for p in plan_backward(*args)))
    _k6b_against_plain(gen, case)


@pytest.mark.cuda
def test_natten3d_refuses_a_gradient(gen):
    """A gradient through a shape K6 serves and K6b's tiles cannot hold (a
    (1, 61, 61) window with rpb: the dq kernel's ds per slot) raises
    ValueError before any launch, under "auto" and "pallas"; "xla"
    differentiates the plain version. Without a gradient K6 serves it."""
    kernel = (1, 61, 61)
    q, k, v, rpb = _natten_inputs(gen, (1, 1, 61, 61), 1, 8, kernel, True)
    leaves = [t.requires_grad_(True) for t in (q, k, v, rpb)]
    before = (natten3d.LAUNCHES, natten3d.BWD_DQ_LAUNCHES, natten_flash.LAUNCHES)
    for impl in ("auto", "pallas"):
        with pytest.raises(ValueError, match="no backward tile"):
            neighborhood_attention_3d(*leaves[:3], kernel, leaves[3], impl=impl)
    with pytest.raises(ValueError, match="no backward tile"):
        natten3d.neighborhood_attention_3d_slot(*leaves[:3], kernel, leaves[3])
    assert (natten3d.LAUNCHES, natten3d.BWD_DQ_LAUNCHES, natten_flash.LAUNCHES) == before
    out = neighborhood_attention_3d(*leaves[:3], kernel, leaves[3], impl="xla")
    out.square().sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in leaves)
    assert (natten3d.LAUNCHES, natten3d.BWD_DQ_LAUNCHES, natten_flash.LAUNCHES) == before
    with torch.no_grad():
        served = neighborhood_attention_3d(q, k, v, kernel, rpb)
    torch.cuda.synchronize()
    assert natten3d.LAUNCHES == before[0] + 1
    assert (served - neighborhood_attention_3d_reference(q, k, v, kernel, rpb)).abs().max().item() <= ATOL


# -- K4a / K4b: banded attention ----------------------------------------------


def _band_case(gen, b, n, heads, c, w, seed=0):
    """A graph whose receivers have up to 6 neighbours within +-w (so edges
    reach the window's ends), every 7th receiver without an edge, in
    512-row blocks (n = 1300: padded rows in the last block); q, k, v, dO
    [b, n, heads, c] on the card."""
    rng = np.random.default_rng(seed)
    receivers = np.repeat(np.arange(n), 6)
    senders = np.clip(receivers + rng.integers(-w, w + 1, receivers.size), 0, n - 1)
    pairs = np.unique(np.stack([receivers, senders], 1), axis=0)
    pairs = pairs[pairs[:, 0] % 7 != 0]
    masks = build_band_masks(pairs[:, 1], pairs[:, 0], n, 512, w)
    empty = ~masks.reshape(-1, masks.shape[-1]).any(-1)[:n]
    q, k, v, dout = (torch.randn(b, n, heads, c, generator=gen, device="cuda") for _ in range(4))
    masks = torch.as_tensor(masks.astype(np.int8), device="cuda")
    return q, k, v, dout, masks, torch.as_tensor(empty, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w", [256, 512])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("c", [16, 128, 512])
def test_banded_flash_matches_plain(gen, c, batch, w):
    """K4a's out and lse against the plain version, B in {1, 2} sharing one
    mask, w = 256 and 512; exact zeros on rows without a neighbour."""
    q, k, v, _, masks, empty = _band_case(gen, batch, 1300, 4, c, w)
    before = banded_flash.LAUNCHES
    with torch.no_grad():
        out = banded_flash.banded_flash_attention(q, k, v, masks, 512, w)
    out_lse, lse = banded_flash._forward_cuda(q, k, v, masks, 512, w, with_lse=True)
    torch.cuda.synchronize()
    assert banded_flash.LAUNCHES == before + 2
    ref, ref_lse = banded_flash.banded_flash_forward_reference(q, k, v, masks, 512, w, with_lse=True)
    assert out.shape == ref.shape == q.shape and lse.shape == (batch, 3 * 512, 4)
    assert (out - ref).abs().max().item() <= ATOL
    assert torch.equal(out, out_lse)
    assert bool((ref_lse < -1e27).any())  # empty and padded rows: -1e28 + log(1e-30)
    assert (lse - ref_lse).abs().max().item() <= ATOL
    assert bool(empty.any()) and bool((out[:, empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("w", [256, 512])
@pytest.mark.parametrize("c", [16, 128, 512])
def test_banded_flash_backward_matches_plain(gen, c, w):
    """K4b (through the autograd Function: K4a with lse, then the dq and
    dk/dv kernels, the latter in its general role: the graph is directed)
    against the plain backward at B = 2; exact-zero dq on rows without a
    neighbour."""
    q, k, v, dout, masks, empty = _band_case(gen, 2, 1300, 4, c, w, seed=1)
    counts = (banded_flash.BWD_DQ_LAUNCHES, banded_flash.BWD_DKV_LAUNCHES)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(banded_flash.banded_flash_attention(*leaves, masks, 512, w), leaves, dout)
    torch.cuda.synchronize()
    assert (banded_flash.BWD_DQ_LAUNCHES, banded_flash.BWD_DKV_LAUNCHES) == (counts[0] + 1, counts[1] + 1)
    out, lse = banded_flash.banded_flash_forward_reference(q, k, v, masks, 512, w, with_lse=True)
    want = banded_flash.banded_flash_backward_reference(q, k, v, masks, out, lse, dout, 512, w)
    for name, a, b in zip("qkv", got, want):
        assert (a - b).abs().max().item() <= ATOL, f"d{name}"
    assert bool((got[0][:, empty] == 0).all())


def _symmetric_band_case(gen, b, n, heads, c, w, seed=0):
    """_band_case's graph made symmetric (each edge and its reverse), every
    7th node without an edge, n = 1300 in 512-row blocks; q, k, v, dO over
    the padded rows (3 * 512) with the masks of the first n nodes."""
    rng = np.random.default_rng(seed)
    receivers = np.repeat(np.arange(n), 3)
    senders = np.clip(receivers + rng.integers(-w, w + 1, receivers.size), 0, n - 1)
    pairs = np.concatenate([np.stack([receivers, senders], 1), np.stack([senders, receivers], 1)])
    pairs = np.unique(pairs, axis=0)
    pairs = pairs[(pairs[:, 0] % 7 != 0) & (pairs[:, 1] % 7 != 0)]
    assert is_symmetric_edges(pairs[:, 1], pairs[:, 0])
    masks = build_band_masks(pairs[:, 1], pairs[:, 0], n, 512, w)
    q, k, v, dout = (torch.randn(b, masks.shape[0] * 512, heads, c, generator=gen, device="cuda")
                     for _ in range(4))
    masks = torch.as_tensor(masks.astype(np.int8), device="cuda")
    return q, k, v, dout, masks


@pytest.mark.cuda
@pytest.mark.parametrize("w", [256, 1024])
@pytest.mark.parametrize("c", [16, 128, 192, 512])
def test_banded_flash_backward_symmetric_role(gen, c, w):
    """K4b's dk/dv kernel in its symmetric role on a symmetric band against
    the plain backward (B = 2), and against the general role: within 1e-4;
    exact-zero gradients in both roles on nodes without an edge and on the
    padded rows past n; one launch of each kernel."""
    n = 1300
    q, k, v, dout, masks = _symmetric_band_case(gen, 2, n, 4, c, w, seed=c)
    counts = (banded_flash.BWD_DQ_LAUNCHES, banded_flash.BWD_DKV_SYMMETRIC_LAUNCHES,
              banded_flash.BWD_DKV_LAUNCHES)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = banded_flash.banded_flash_attention(*leaves, masks, 512, w, symmetric=True)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (banded_flash.BWD_DQ_LAUNCHES, banded_flash.BWD_DKV_SYMMETRIC_LAUNCHES,
            banded_flash.BWD_DKV_LAUNCHES) == (counts[0] + 1, counts[1] + 1, counts[2])
    ref, lse = banded_flash.banded_flash_forward_reference(q, k, v, masks, 512, w, with_lse=True)
    want = banded_flash.banded_flash_backward_reference(q, k, v, masks, ref, lse, dout, 512, w)
    general = banded_flash._backward_cuda(q, k, v, masks, ref, lse, dout, 512, w, symmetric=False)
    torch.cuda.synchronize()
    for name, a, b, g in zip("qkv", got, want, general):
        assert (a - b).abs().max().item() <= ATOL, f"d{name}"
        assert (a - g).abs().max().item() <= ATOL, f"d{name} against the general role"
    empty = torch.arange(q.shape[1], device="cuda")
    empty = (empty % 7 == 0) | (empty >= n)
    for t in (*got, *general):
        assert bool((t[:, empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("c", [32, 33, 128, 512])
def test_banded_flash_tensor_core_tiles(gen, c, batch):
    """K4a on the tensor cores against its plain version at the widths of
    its tile classes (32; 33, past a class and not a multiple of 4: scalar
    copies; 128; 512: four warps a row group), B in {1, 2}: out and lse
    within 1e-4, rows without a neighbour exactly 0."""
    q, k, v, _, masks, empty = _band_case(gen, batch, 1300, 2, c, 512, seed=c)
    before = banded_flash.LAUNCHES
    out, lse = banded_flash._forward_cuda(q, k, v, masks, 512, 512, with_lse=True)
    torch.cuda.synchronize()
    assert banded_flash.LAUNCHES == before + 1
    ref, ref_lse = banded_flash.banded_flash_forward_reference(q, k, v, masks, 512, 512, with_lse=True)
    assert (out - ref).abs().max().item() <= ATOL
    assert (lse - ref_lse).abs().max().item() <= ATOL
    assert bool((out[:, empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 128, 512])
def test_banded_flash_one_edge_in_the_last_subtile_and_an_empty_block(gen, c):
    """Receiver 511 of block 0 has its only edge on the last slot of its
    window (the last 16-key warp tile of the last copied tile); block 1 has
    no edge at all: its rows come out exactly 0, their lse -1e28 +
    log(1e-30), with and without lse; B = 2."""
    n, w = 1024, 512
    masks = build_band_masks(np.array([511 + w]), np.array([511]), n, 512, w)
    assert masks[0].nonzero()[1].tolist() == [512 + 2 * w - 1]
    masks = torch.as_tensor(masks.astype(np.int8), device="cuda")
    q, k, v = (torch.randn(2, n, 2, c, generator=gen, device="cuda") for _ in range(3))
    out, lse = banded_flash._forward_cuda(q, k, v, masks, 512, w, with_lse=True)
    served = banded_flash._forward_cuda(q, k, v, masks, 512, w, with_lse=False)[0]
    torch.cuda.synchronize()
    assert torch.equal(out, served)
    assert (out[:, 511] - v[:, 1023]).abs().max().item() <= ATOL
    assert bool((out[:, :511] == 0).all()) and bool((out[:, 512:] == 0).all())
    empty_lse = torch.tensor(-1e28, dtype=torch.float32) + torch.log(torch.tensor(1e-30))
    assert bool((lse[:, 512:] == empty_lse.item()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["clustered_flash", "clustered_flash_bwd", "banded_flash",
                                  "banded_flash_bwd", "edge_mlp", "fused_mlp_bwd"])
def test_tensor_core_sass(gen, name):
    """The libraries whose products run on the tensor cores hold TF32 mma
    instructions (HMMA ... TF32) in their SASS (cuobjdump beside nvcc)."""
    import re
    import subprocess
    from pathlib import Path

    from graph_weather_tpu_torch.ops import _build

    _build.load_libraries([name])
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build._so_path(name))],
                          capture_output=True, text=True, check=True).stdout
    assert len(re.findall(r"HMMA\.\S*TF32", sass)) > 0


@pytest.mark.cuda
def test_banded_flash_unbatched_odd_width(gen):
    """[N, h, c] inputs with c = 6 (not a multiple of 4: the scalar copies),
    forward and backward, against the plain versions."""
    q, k, v, dout, masks, empty = _band_case(gen, 1, 700, 2, 6, 256, seed=2)
    q, k, v, dout = q[0], k[0], v[0], dout[0]
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = banded_flash.banded_flash_attention(*leaves, masks, 512, 256)
    got = torch.autograd.grad(out, leaves, dout)
    ref, lse = banded_flash.banded_flash_forward_reference(q, k, v, masks, 512, 256, with_lse=True)
    want = banded_flash.banded_flash_backward_reference(q, k, v, masks, ref, lse, dout, 512, 256)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= ATOL
    assert _max_err(got, want) <= ATOL
    assert bool((out[empty] == 0).all())


@pytest.mark.cuda
def test_banded_flash_gradients_flow(gen):
    """Gradients through the autograd Function on the card against autograd
    of the plain forward in float64 on the CPU; the kernels refuse what they
    cannot take."""
    q, k, v, dout, masks, _ = _band_case(gen, 2, 1300, 2, 32, 512, seed=3)
    before = banded_flash.LAUNCHES
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(banded_flash.banded_flash_attention(*leaves, masks, 512, 512), leaves, dout)
    assert banded_flash.LAUNCHES == before + 1
    q64, k64, v64 = (t.detach().cpu().double().requires_grad_(True) for t in (q, k, v))
    out = banded_flash.banded_flash_forward_reference(q64, k64, v64, masks.cpu(), 512, 512)
    want = torch.autograd.grad(out, (q64, k64, v64), dout.cpu().double())
    assert max((a.cpu().double() - b).abs().max().item() for a, b in zip(got, want)) <= ATOL
    wide = torch.zeros(1, 1300, 1, 513, device="cuda")
    with pytest.raises(ValueError, match="head width"):
        banded_flash.banded_flash_attention(wide, wide, wide, masks, 512, 512)
    with pytest.raises(TypeError, match="int8"):
        banded_flash.banded_flash_attention(q, k, v, masks.bool(), 512, 512)


# -- K4a and K4b in bf16 -----------------------------------------------------------


def _k4_counts():
    return tuple(getattr(banded_flash, prefix + name) for prefix in ("", "BF16_") for name in (
        "LAUNCHES", "BWD_DQ_LAUNCHES", "BWD_DKV_SYMMETRIC_LAUNCHES", "BWD_DKV_LAUNCHES"))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("c", [16, 32, 128, 192, 512])
def test_banded_flash_bf16_matches_plain(gen, c, batch):
    """K4a in bf16 (with and without lse, and through the autograd
    Function) and K4b in bf16 (dq; dk/dv in the symmetric and the general
    role) against their plain versions on bf16 inputs, on a symmetric band
    at w = 512 over the padded rows, at each tile width (c = 16: zeros to
    32; 192 and 512: warps that share a row group), B in {1, 2}: out, dq,
    dk and dv within 2 ulps of their max, lse within ATOL, exact zeros on
    nodes without an edge and on the padded rows, the backward bit-equal
    over two launches; the bf16 launch counts move, the f32 ones do not."""
    n, w = 1300, 512
    q, k, v, dout, masks = _symmetric_band_case(gen, batch, n, 4, c, w, seed=c)
    q, k, v, dout = (t.bfloat16() for t in (q, k, v, dout))
    before = _k4_counts()
    with torch.no_grad():
        out = banded_flash.banded_flash_attention(q, k, v, masks, 512, w)
    out_l, lse = banded_flash._forward_cuda(q, k, v, masks, 512, w, with_lse=True)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    sym = torch.autograd.grad(
        banded_flash.banded_flash_attention(*leaves, masks, 512, w, symmetric=True), leaves, dout)
    general = banded_flash._backward_cuda(q, k, v, masks, out_l, lse, dout, 512, w, symmetric=False)
    again = banded_flash._backward_cuda(q, k, v, masks, out_l, lse, dout, 512, w, symmetric=True)
    torch.cuda.synchronize()
    made = tuple(a - b for a, b in zip(_k4_counts(), before))
    assert made == (0, 0, 0, 0, 3, 3, 2, 1)
    ref, ref_lse = banded_flash.banded_flash_forward_reference(q, k, v, masks, 512, w, with_lse=True)
    want = banded_flash.banded_flash_backward_reference(q, k, v, masks, ref, ref_lse, dout, 512, w)
    assert out.dtype == out_l.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _bf16_err(out, ref) <= 1 and _bf16_err(out_l, ref) <= 1
    assert (lse - ref_lse).abs().max().item() <= ATOL
    assert all(torch.equal(a, b) for a, b in zip(sym, again))
    empty = torch.arange(q.shape[1], device="cuda")
    empty = (empty % 7 == 0) | (empty >= n)
    for grads in (sym, general):
        assert all(g.dtype == torch.bfloat16 for g in grads)
        assert max(_bf16_err(a, b) for a, b in zip(grads, want)) <= 1
        assert all(bool((t[:, empty] == 0).all()) for t in grads)
    assert bool((out[:, empty] == 0).all())


@pytest.mark.cuda
def test_banded_flash_bf16_unbatched_odd_width(gen):
    """[N, h, c] bf16 inputs with c = 6 (the 2-byte copies), on a directed
    band at w = 256: forward and backward (the general role) against the
    plain versions within 2 ulps of their max; heads above 512 refused
    before any launch."""
    q, k, v, dout, masks, empty = _band_case(gen, 1, 700, 2, 6, 256, seed=4)
    q, k, v, dout = (t[0].bfloat16() for t in (q, k, v, dout))
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = banded_flash.banded_flash_attention(*leaves, masks, 512, 256)
    got = torch.autograd.grad(out, leaves, dout)
    ref, lse = banded_flash.banded_flash_forward_reference(q, k, v, masks, 512, 256, with_lse=True)
    want = banded_flash.banded_flash_backward_reference(q, k, v, masks, ref, lse, dout, 512, 256)
    torch.cuda.synchronize()
    assert _bf16_err(out, ref) <= 1
    assert max(_bf16_err(a, b) for a, b in zip(got, want)) <= 1
    assert bool((out[empty] == 0).all())
    before = _k4_counts()
    wide = torch.zeros(1, 700, 1, 513, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head width"):
        banded_flash.banded_flash_attention(wide, wide, wide, masks, 512, 256)
    assert _k4_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["banded_flash", "banded_flash_bwd"])
def test_banded_flash_bf16_sass(gen, name):
    """K4a's and K4b's libraries hold bf16 mma instructions (HMMA ... BF16)
    beside their TF32 ones (cuobjdump beside nvcc)."""
    import re
    import subprocess
    from pathlib import Path

    from graph_weather_tpu_torch.ops import _build

    _build.load_libraries([name])
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build._so_path(name))],
                          capture_output=True, text=True, check=True).stdout
    assert len(re.findall(r"HMMA\.\S*BF16", sass)) > 0
    assert len(re.findall(r"HMMA\.\S*TF32", sass)) > 0


# -- K6 and K6b in bf16 ------------------------------------------------------------

K6_BF16_CASES = [K6_CASES[i] for i in (0, 1, 4, 7, 9)]
K6_BF16_IDS = [K6_IDS[i] for i in (0, 1, 4, 7, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K6_BF16_CASES, ids=K6_BF16_IDS)
def test_natten3d_bf16_matches_plain(gen, case):
    """K6's bf16 mode against the slot scan in bf16: out within two bf16 ulps
    of its max, lse within 1e-4, out32 (out before its rounding) within 1e-4;
    bit-equal over two launches."""
    shape, heads, ch, kernel, with_rpb, circular = case
    q, k, v, rpb = _bf16_inputs(gen, shape, heads, ch, kernel, with_rpb)
    before = (natten3d.LAUNCHES, natten3d.BF16_LAUNCHES)
    out32 = torch.empty(q.shape, device="cuda")
    out, lse = natten3d._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True, out32=out32)
    out2, lse2 = natten3d._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True)
    torch.cuda.synchronize()
    assert (natten3d.LAUNCHES, natten3d.BF16_LAUNCHES) == (before[0], before[1] + 2)
    ref, ref_lse, ref32 = natten3d.slot_forward(q, k, v, kernel, rpb, circular)
    assert out.dtype == torch.bfloat16 and _bf16_err(out, ref) <= 1
    assert (lse - ref_lse).abs().max().item() <= ATOL
    assert (out32 - ref32).abs().max().item() <= ATOL
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K6_BF16_CASES, ids=K6_BF16_IDS)
def test_natten3d_bf16_backward_matches_plain(gen, case):
    """K6b's bf16 mode through the dispatcher's autograd path (K6 with lse
    and out32; the dq, dk/dv and the two drpb kernels, one launch each)
    against the slot scan's bf16 backward: every gradient within two bf16
    ulps of its max; bit-equal over two backwards."""
    shape, heads, ch, kernel, with_rpb, circular = case
    q, k, v, rpb = _bf16_inputs(gen, shape, heads, ch, kernel, with_rpb)
    dout = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v) + ((rpb,) if with_rpb else ())]

    def counts():
        return (natten3d.BF16_LAUNCHES, natten3d.BF16_BWD_DQ_LAUNCHES, natten3d.BF16_BWD_DKV_LAUNCHES,
                natten3d.BF16_DRPB_SLOT_LAUNCHES, natten3d.BF16_DRPB_LAUNCHES, natten3d.LAUNCHES)

    before = counts()
    out = neighborhood_attention_3d(*leaves[:3], kernel, leaves[3] if with_rpb else None, circular,
                                    impl="pallas")
    got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    again = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    n = 2 * with_rpb
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 2, 2, n, n, 0)
    ref_out, lse, out32 = natten3d.slot_forward(q, k, v, kernel, rpb, circular)
    want = natten3d.slot_backward_reference(q, k, v, rpb, out32, lse, dout, kernel, circular)
    for name, a, b in zip(("dq", "dk", "dv", "drpb"), got, want):
        assert a.dtype == torch.bfloat16 and _bf16_err(a, b) <= 1, name
    assert all(torch.equal(a, b) for a, b in zip(got, again))
