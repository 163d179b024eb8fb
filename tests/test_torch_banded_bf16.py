"""The banded attention's bf16 mode on the CPU: the port's plain K4a (with
and without lse) and K4b on bf16 inputs against the JAX package's
banded_flash_attention on bf16 inputs, run as its own tests run it on the
CPU (interpret=True), and the plain `banded` option in bf16 against the JAX
package's banded_graph_attention in bf16 (jitted).

The band is two blocks of 512 rows (n = 1,000, 24 padded rows) at w = 512,
random neighbours within +-w (tests/test_torch_banded.py's graph), with two
receivers that have no edge, and a symmetrised copy whose node 7 has no edge
at all. Inputs are drawn in f32 from numpy with a seed and rounded to bf16
once, the same bits for both packages.

Tolerance: out, dq, dk and dv within 2 bf16 ulps of max|JAX| (2^-6 max):
both round p, ds and the outputs to bf16 at the same points and sum the
products in f32 in another order; the TPU kernel's forward also rounds p
against the running max of its own 512-key tiles, which the plain version
walks too. lse (f32) within 1e-4. The `banded` option rounds each bf16 op
as XLA does: its output matches bit for bit, its gradients (autograd's bf16
softmax backward, rounded at other points than JAX's) within 2^-6 max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.ops.banded_attention import banded_graph_attention as jax_banded
from graph_weather_tpu.ops.pallas.banded_flash import _flash_impl as jax_flash_impl
from graph_weather_tpu.ops.pallas.banded_flash import banded_flash_attention as jax_banded_flash
from graph_weather_tpu_torch.ops import banded_flash
from graph_weather_tpu_torch.ops.banded_attention import banded_graph_attention, build_band_masks
from graph_weather_tpu_torch.ops.banded_flash import (
    banded_flash_attention,
    banded_flash_backward_reference,
    banded_flash_forward_reference,
)

torch.set_num_threads(1)
ULPS2 = 2.0**-6  # two bf16 ulps (8 significant bits) of the largest value
LSE_ATOL = 1e-4
N, HEADS, BLOCK, W = 1000, 2, 512, 512
EMPTY = [0, 600]  # receivers without an edge in the directed band
ISOLATED = 7  # no edge in either direction in the symmetric band


@pytest.fixture(scope="module")
def bands():
    """{symmetric: int8 masks [2, 512, 1536]}."""
    rng = np.random.default_rng(0)
    receivers = np.repeat(np.arange(N), 6)
    lo, hi = np.maximum(0, receivers - W), np.minimum(N, receivers + W + 1)
    senders = lo + (rng.random(receivers.size) * (hi - lo)).astype(np.int64)
    pairs = np.unique(np.stack([receivers, senders], 1), axis=0)
    directed = pairs[~np.isin(pairs[:, 0], EMPTY)]
    both = np.concatenate([pairs, pairs[:, ::-1]])
    both = np.unique(both[(both != ISOLATED).all(1)], axis=0)
    return {
        sym: build_band_masks(p[:, 1], p[:, 0], N, BLOCK, W).astype(np.int8)
        for sym, p in ((False, directed), (True, both))
    }


def _inputs(seed, c, count=4):
    """q, k, v and a cotangent: f32 draws, as bf16 for JAX and for torch."""
    rng = np.random.default_rng(seed)
    draws = [rng.standard_normal((N, HEADS, c)).astype(np.float32) for _ in range(count)]
    return [jnp.asarray(a, jnp.bfloat16) for a in draws], [torch.from_numpy(a).bfloat16() for a in draws]


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _within_two_ulps(got, want, name):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, name
    limit = ULPS2 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= limit, f"{name}: max |port - JAX| {err:.3e} > 2^-6 max|JAX| = {limit:.3e}"


@pytest.mark.parametrize("c", [128, 512])
def test_plain_forward_matches_jax_bf16(bands, c):
    """out (bf16) and lse (f32) of the plain K4a against the Pallas K4a on
    bf16 inputs in the interpreter, with and without lse; exact zeros on
    rows without an edge and on padded rows."""
    masks = bands[False]
    (jq, jk, jv), (q, k, v) = _inputs(c, c, 3)
    want, want_lse = jax_flash_impl(jq, jk, jv, jnp.asarray(masks), BLOCK, W, True, with_lse=True)
    want_lse = np.asarray(want_lse).reshape(-1, HEADS, 128)[..., 0]
    t_masks = torch.from_numpy(masks)
    out, lse = banded_flash_forward_reference(q, k, v, t_masks, BLOCK, W, with_lse=True)
    served = banded_flash_forward_reference(q, k, v, t_masks, BLOCK, W)
    assert want.dtype == jnp.bfloat16 and out.dtype == served.dtype == torch.bfloat16
    assert lse.dtype == torch.float32 and lse.shape == (2 * BLOCK, HEADS)
    assert torch.equal(out, served)
    _within_two_ulps(out, want, "out")
    real = want_lse > -1e27  # rows with a neighbour; the others hold -1e28 + log(1e-30)
    assert not real[EMPTY].any() and not real[N:].any()
    np.testing.assert_allclose(lse.numpy()[real], want_lse[real], atol=LSE_ATOL)
    np.testing.assert_allclose(lse.numpy()[~real], want_lse[~real], rtol=1e-6)
    assert bool((out[EMPTY] == 0).all())


@pytest.mark.parametrize(
    "c,symmetric", [(128, False), (128, True), (512, True)],
    ids=["c128_general", "c128_symmetric", "c512_symmetric"],
)
def test_plain_backward_matches_jax_bf16(bands, c, symmetric):
    """dq, dk, dv (bf16) of the port's autograd Function on the CPU (the
    plain K4a with lse, then the plain K4b; `symmetric` names the card's
    dk/dv role and must not change the result) against jax.vjp through the
    JAX package's bf16 Pallas K4b."""
    masks = bands[symmetric]
    (jq, jk, jv, jcot), (q, k, v, cot) = _inputs(10 * c + symmetric, c)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_banded_flash(q, k, v, jnp.asarray(masks), BLOCK, W, interpret=True),
        jq, jk, jv,
    )
    want = vjp(jcot)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = banded_flash_attention(*leaves, torch.from_numpy(masks), BLOCK, W, symmetric=symmetric)
    got = torch.autograd.grad(out, leaves, cot)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        _within_two_ulps(a, b, f"d{name}")
    empty = [ISOLATED] if symmetric else EMPTY
    assert bool((got[0][empty] == 0).all())
    if symmetric:
        assert all(bool((g[ISOLATED] == 0).all()) for g in got)


def test_banded_option_bf16_matches_jax(bands):
    """The plain `banded` attention on bf16 inputs against the JAX package's
    banded_graph_attention in bf16 (jitted): the output bit for bit, dq, dk
    and dv within 2^-6 max; exact zeros on rows without an edge."""
    masks = bands[False].astype(bool)
    (jq, jk, jv, jcot), (q, k, v, cot) = _inputs(5, 128)
    want, vjp = jax.vjp(
        jax.jit(lambda q, k, v: jax_banded(q, k, v, jnp.asarray(masks), BLOCK, W)), jq, jk, jv
    )
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = banded_graph_attention(*leaves, torch.from_numpy(masks), BLOCK, W)
    assert want.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(out.detach()), _f32(want))
    got = torch.autograd.grad(out, leaves, cot)
    for name, a, b in zip("qkv", got, vjp(jcot)):
        assert a.dtype == torch.bfloat16
        _within_two_ulps(a, b, f"d{name}")
    assert bool((out[EMPTY] == 0).all())


def test_bf16_f32_paths_differ_only_by_rounding(bands):
    """The same bf16 values through the plain versions in f32 and in bf16:
    the bf16 results are the f32 ones to within bf16 rounding (a few ulps),
    and are not the f32 ones exactly (the rounding points are really there)."""
    masks = torch.from_numpy(bands[True])
    _, (q, k, v, dout) = _inputs(3, 32)
    out16, lse16 = banded_flash_forward_reference(q, k, v, masks, BLOCK, W, with_lse=True)
    q32, k32, v32, d32 = (t.float() for t in (q, k, v, dout))
    out32, lse32 = banded_flash_forward_reference(q32, k32, v32, masks, BLOCK, W, with_lse=True)
    torch.testing.assert_close(lse16, lse32, rtol=0, atol=1e-5)
    grads16 = banded_flash_backward_reference(q, k, v, masks, out16, lse16, dout, BLOCK, W)
    grads32 = banded_flash_backward_reference(q32, k32, v32, masks, out32, lse32, d32, BLOCK, W)
    plain16 = banded_graph_attention(q, k, v, masks, BLOCK, W)
    for a, b in zip((out16, *grads16, plain16), (out32, *grads32, out32)):
        assert a.dtype == torch.bfloat16
        err = (a.float() - b).abs().max().item()
        assert 0 < err <= 4 * ULPS2 * b.abs().max().item()


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch(bands):
    """bf16 on the CPU: the wrapper's result is the plain version's, bit for
    bit, forward and backward, in both roles, and no kernel count moves."""
    masks = torch.from_numpy(bands[True])
    _, (q, k, v, dout) = _inputs(4, 32)
    names = ("LAUNCHES", "BWD_DQ_LAUNCHES", "BWD_DKV_SYMMETRIC_LAUNCHES", "BWD_DKV_LAUNCHES")
    counts = lambda: tuple(  # noqa: E731
        getattr(banded_flash, prefix + name) for prefix in ("", "BF16_") for name in names
    )
    before = counts()
    out = banded_flash_attention(q, k, v, masks, BLOCK, W)
    assert torch.equal(out, banded_flash_forward_reference(q, k, v, masks, BLOCK, W))
    ref_out, lse = banded_flash_forward_reference(q, k, v, masks, BLOCK, W, with_lse=True)
    want = banded_flash_backward_reference(q, k, v, masks, ref_out, lse, dout, BLOCK, W)
    for symmetric in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(
            banded_flash_attention(*leaves, masks, BLOCK, W, symmetric=symmetric), leaves, dout
        )
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counts() == before


@pytest.mark.parametrize(
    "dtypes",
    [(torch.float16,) * 3, (torch.bfloat16, torch.float32, torch.float32),
     (torch.float32, torch.float32, torch.bfloat16)],
    ids=["f16", "bf16_q_only", "bf16_v_only"],
)
def test_wrapper_refuses_other_dtypes(dtypes):
    """q, k and v are all f32 or all bf16; anything else raises."""
    masks = torch.zeros(2, BLOCK, BLOCK + 2 * W, dtype=torch.int8)
    q, k, v = (torch.zeros(N, HEADS, 8, dtype=d) for d in dtypes)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        banded_flash_attention(q, k, v, masks, BLOCK, W)
