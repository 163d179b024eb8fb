"""The clustered attention's bf16 mode on the CPU: the port's plain K3a (with
lse), K3c and K3b on bf16 inputs against the JAX package's
clustered_flash_attention on bf16 inputs, run as its own tests run it on the
CPU (interpret=True).

The layout is a random graph on n = 600 nodes in 128-row blocks (nb = 5,
40 padded rows), with three receivers that have no edge, and a symmetrised
copy whose node 7 has no edge at all. Inputs are drawn in f32 from numpy
with a seed and rounded to bf16 once, the same bits for both packages.

Tolerance: out, dq, dk and dv within 2 bf16 ulps of max|JAX| (2^-6 max):
both round p, ds and the outputs to bf16 at the same points and sum the
products in f32 in another order, so a few elements round to the
neighbouring bf16 value; lse (f32) within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.ops.pallas.clustered_flash import _clustered_fwd
from graph_weather_tpu.ops.pallas.clustered_flash import (
    clustered_flash_attention as jax_clustered,
)
from graph_weather_tpu_torch.meshes.clustering import build_cluster_layout, is_symmetric_edges
from graph_weather_tpu_torch.ops import clustered_flash
from graph_weather_tpu_torch.ops.clustered_flash import (
    clustered_flash_attention,
    clustered_flash_backward_reference,
    clustered_flash_forward_reference,
)

torch.set_num_threads(1)
ULPS2 = 2.0**-6  # two bf16 ulps (8 significant bits) of the largest value
LSE_ATOL = 1e-4
N, HEADS, BLOCK = 600, 2, 128
EMPTY = [0, 300, 599]  # receivers without an edge in the directed graph
ISOLATED = 7  # no edge in either direction in the symmetric graph


@pytest.fixture(scope="module")
def layouts():
    rng = np.random.default_rng(0)
    receivers = np.repeat(np.arange(N), 6)
    senders = (receivers + rng.integers(-40, 41, receivers.size)) % N
    keep = ~np.isin(receivers, EMPTY)
    directed = build_cluster_layout(senders[keep], receivers[keep], N, N, block=BLOCK)
    keep = (senders != ISOLATED) & (receivers != ISOLATED)
    pairs = np.unique(
        np.stack([np.r_[senders[keep], receivers[keep]], np.r_[receivers[keep], senders[keep]]], 1),
        axis=0,
    )
    assert is_symmetric_edges(pairs[:, 0], pairs[:, 1])
    symmetric = build_cluster_layout(pairs[:, 0], pairs[:, 1], N, N, block=BLOCK)
    assert directed.n_blocks == symmetric.n_blocks == 5
    return {False: directed, True: symmetric}


def _inputs(seed, batch, c):
    """q, k, v and a cotangent: f32 draws, as bf16 for JAX and for torch."""
    rng = np.random.default_rng(seed)
    draws = [rng.standard_normal((batch, N, HEADS, c)).astype(np.float32) for _ in range(4)]
    return [jnp.asarray(a, jnp.bfloat16) for a in draws], [torch.from_numpy(a).bfloat16() for a in draws]


def _ids_masks(layout):
    return layout.gather_ids, layout.masks.astype(np.int8)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _within_two_ulps(got, want, name):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, name
    limit = ULPS2 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= limit, f"{name}: max |port - JAX| {err:.3e} > 2^-6 max|JAX| = {limit:.3e}"


# (c, batch): every tile width of the kernels' bf16 instantiations at B = 1,
# and B = 2 at the narrowest (the JAX compiles, not the sizes, take the time).
CASES = [(32, 1), (32, 2), (128, 1), (512, 1)]


@pytest.mark.parametrize("c,batch", CASES)
def test_plain_forward_with_lse_matches_jax_bf16(layouts, c, batch):
    """out (bf16) and lse (f32) of the plain forward against the JAX
    package's _clustered_fwd on bf16 inputs; exact zeros on empty rows."""
    ids, masks = _ids_masks(layouts[False])
    (jq, jk, jv, _), (q, k, v, _) = _inputs(c + batch, batch, c)
    want, residuals = _clustered_fwd(jq, jk, jv, jnp.asarray(ids), jnp.asarray(masks), BLOCK, True, False)
    nb = ids.shape[0]
    want_lse = np.asarray(residuals[-1]).reshape(batch, nb * BLOCK, HEADS, 128)[..., 0]
    out, lse = clustered_flash_forward_reference(
        q, k, v, torch.from_numpy(ids), torch.from_numpy(masks), BLOCK, with_lse=True
    )
    assert want.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _within_two_ulps(out, want, "out")
    real = want_lse > -1e27  # rows with a neighbour
    np.testing.assert_allclose(lse.numpy()[real], want_lse[real], atol=LSE_ATOL)
    np.testing.assert_allclose(lse.numpy()[~real], want_lse[~real], rtol=1e-6)
    assert bool((out[:, EMPTY] == 0).all())


@pytest.mark.parametrize("symmetric", [False, True], ids=["general", "symmetric"])
@pytest.mark.parametrize("c,batch", CASES)
def test_plain_backward_matches_jax_bf16(layouts, c, batch, symmetric):
    """dq, dk, dv (bf16) of the port's autograd Function on the CPU (the
    plain forward with lse, then the plain K3b or K3c) against jax.vjp
    through the JAX package's bf16 K3b (general) or K3c (symmetric)."""
    ids, masks = _ids_masks(layouts[symmetric])
    (jq, jk, jv, jcot), (q, k, v, cot) = _inputs(10 * c + batch, batch, c)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_clustered(
            q, k, v, jnp.asarray(ids), jnp.asarray(masks), BLOCK, interpret=True, symmetric=symmetric
        ),
        jq, jk, jv,
    )
    want = vjp(jcot)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = clustered_flash_attention(
        *leaves, torch.from_numpy(ids), torch.from_numpy(masks), BLOCK, symmetric=symmetric
    )
    got = torch.autograd.grad(out, leaves, cot)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        _within_two_ulps(a, b, f"d{name}")
    if symmetric:
        assert all(bool((g[:, ISOLATED] == 0).all()) for g in got)
    else:
        assert bool((got[0][:, EMPTY] == 0).all())


def test_bf16_f32_paths_differ_only_by_rounding(layouts):
    """The same bf16 values through the plain versions in f32 and in bf16:
    the bf16 results are the f32 ones to within bf16 rounding (a few ulps),
    and are not the f32 ones exactly (the rounding points are really there)."""
    ids, masks = (torch.from_numpy(a) for a in _ids_masks(layouts[True]))
    _, (q, k, v, dout) = _inputs(3, 2, 32)
    out16, lse16 = clustered_flash_forward_reference(q, k, v, ids, masks, BLOCK, with_lse=True)
    q32, k32, v32, d32 = (t.float() for t in (q, k, v, dout))
    out32, lse32 = clustered_flash_forward_reference(q32, k32, v32, ids, masks, BLOCK, with_lse=True)
    assert torch.equal(lse16, lse32)
    grads16 = clustered_flash_backward_reference(q, k, v, ids, masks, out16, lse16, dout, BLOCK, True)
    grads32 = clustered_flash_backward_reference(
        q32, k32, v32, ids, masks, out32, lse32, d32, BLOCK, True
    )
    for a, b in zip((out16, *grads16), (out32, *grads32)):
        assert a.dtype == torch.bfloat16
        err = (a.float() - b).abs().max().item()
        assert 0 < err <= 4 * ULPS2 * b.abs().max().item()


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch(layouts):
    """bf16 on the CPU: the wrapper's result is the plain version's, bit for
    bit, forward and backward, and no kernel count moves."""
    ids, masks = (torch.from_numpy(a) for a in _ids_masks(layouts[True]))
    _, (q, k, v, dout) = _inputs(4, 1, 32)
    names = ("LAUNCHES", "GENERAL_BWD_LAUNCHES", "SYMMETRIC_DQ_LAUNCHES", "SYMMETRIC_DKV_LAUNCHES")
    counts = lambda: tuple(  # noqa: E731
        getattr(clustered_flash, prefix + name) for prefix in ("", "BF16_") for name in names
    )
    before = counts()
    out = clustered_flash_attention(q, k, v, ids, masks, BLOCK)
    assert torch.equal(out, clustered_flash_forward_reference(q, k, v, ids, masks, BLOCK))
    for symmetric in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(
            clustered_flash_attention(*leaves, ids, masks, BLOCK, symmetric=symmetric), leaves, dout
        )
        ref_out, lse = clustered_flash_forward_reference(q, k, v, ids, masks, BLOCK, with_lse=True)
        want = clustered_flash_backward_reference(
            q, k, v, ids, masks, ref_out, lse, dout, BLOCK, symmetric
        )
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counts() == before


@pytest.mark.parametrize(
    "dtypes",
    [(torch.float16,) * 3, (torch.bfloat16, torch.float32, torch.float32),
     (torch.float32, torch.float32, torch.bfloat16)],
    ids=["f16", "bf16_q_only", "bf16_v_only"],
)
def test_wrapper_refuses_other_dtypes(layouts, dtypes):
    """q, k and v are all f32 or all bf16; anything else raises."""
    ids, masks = (torch.from_numpy(a) for a in _ids_masks(layouts[True]))
    q, k, v = (torch.zeros(1, N, HEADS, 8, dtype=d) for d in dtypes)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        clustered_flash_attention(q, k, v, ids, masks, BLOCK)


@pytest.mark.parametrize(
    "c, dtype, symmetric, tile",
    [(32, torch.bfloat16, True, "W32"), (128, torch.bfloat16, True, "W128"),
     (129, torch.bfloat16, True, "M192"), (192, torch.bfloat16, True, "M192"),
     (193, torch.bfloat16, True, "W256"), (256, torch.bfloat16, True, "W256"),
     (192, torch.float32, True, "W256"), (192, torch.bfloat16, False, "W256"),
     (257, torch.bfloat16, True, "W512"), (768, torch.bfloat16, True, "W768")],
)
def test_backward_tile(c, dtype, symmetric, tile):
    """The tile of csrc/clustered_flash_bwd.cu that the backward takes (its
    `backward`): K3c in bf16 at 128 < c <= 192 (FGN's c = 192) on the M192
    tile, counted apart; wider heads, f32 and K3b's general backward keep
    W256; by width otherwise."""
    assert clustered_flash.backward_tile(c, dtype, symmetric) == tile
