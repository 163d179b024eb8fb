"""The clustered attention at FGN's head widths, on the CPU: the port's plain
K3a (with lse) and K3c (the symmetric backward) at c = 192 (FGN's 23 blocks
of 768 / 4 heads) and c = 768 (its last block, heads averaged), in f32 and
bf16, against the JAX package's clustered_flash_attention run as its own
tests run it on the CPU (interpret=True; the TPU kernel pads c to whole
lanes). On the card K3a and K3c take these widths (W256 and W768 tiles,
csrc/clustered_flash{,_bwd}.cu); K3b's general dk/dv kernel and the banded
kernels K4a/K4b stop at 512 and refuse wider heads before any launch.

The layout: a symmetrised random graph on n = 700 nodes in 256-row blocks
(FGN's block; nb = 3, 68 padded rows) whose node 7 has no edge. Inputs from
numpy with a seed (bf16: rounded once, the same bits for both packages).
Tolerances: f32 atol 3e-5 (tests/test_torch_clustered_flash_bwd.py's: sums
over a few hundred products in another order); bf16 two bf16 ulps of the
largest value (2^-6 max, tests/test_torch_clustered_bf16.py's); lse 1e-4.

The JAX package's f32 backward refuses c = 768 at this block (its working
set passes its VMEM budget at any head group, in K3c's and K3b's kernels
alike), so there the f32 gradients are held to jax.vjp of the JAX
package's segment-softmax attention over the same edges, the function the
kernels compute.
"""

from functools import cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.ops.pallas.clustered_flash import _clustered_fwd
from graph_weather_tpu.ops.pallas.clustered_flash import (
    clustered_flash_attention as jax_clustered,
)
from graph_weather_tpu.ops.segment_softmax import segment_softmax as jax_segment_softmax
from graph_weather_tpu_torch.meshes.clustering import build_cluster_layout, is_symmetric_edges
from graph_weather_tpu_torch.ops import banded_flash, clustered_flash
from graph_weather_tpu_torch.ops.clustered_flash import (
    clustered_flash_attention,
    clustered_flash_forward_reference,
)

torch.set_num_threads(1)
ATOL, ULPS2, LSE_ATOL = 3e-5, 2.0**-6, 1e-4
N, BLOCK, ISOLATED = 700, 256, 7
CASES = [(192, 2), (768, 1)]  # (c, heads)


@cache
def _layout():
    rng = np.random.default_rng(0)
    receivers = np.repeat(np.arange(N), 6)
    senders = (receivers + rng.integers(-60, 61, receivers.size)) % N
    keep = (senders != ISOLATED) & (receivers != ISOLATED)
    pairs = np.unique(
        np.stack([np.r_[senders[keep], receivers[keep]], np.r_[receivers[keep], senders[keep]]], 1),
        axis=0,
    )
    assert is_symmetric_edges(pairs[:, 0], pairs[:, 1])
    layout = build_cluster_layout(pairs[:, 0], pairs[:, 1], N, N, block=BLOCK)
    assert layout.n_blocks == 3
    return layout.gather_ids, layout.masks.astype(np.int8), pairs[np.lexsort(pairs.T)]  # by receiver


def _segment_attention(q, k, v, pairs):
    """The JAX package's segment-softmax graph attention over (sender,
    receiver) pairs sorted by receiver: [1, N, h, c] -> [1, N, h, c]."""
    s, r = jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])
    logits = jnp.sum(q[:, r] * k[:, s], -1) / np.sqrt(q.shape[-1])
    alpha = jax_segment_softmax(logits, r, N)
    return jax.ops.segment_sum(jnp.moveaxis(alpha[..., None] * v[:, s], 1, 0), r, N,
                               indices_are_sorted=True).swapaxes(0, 1)


def _draws(seed, c, heads, dtype):
    """q, k, v and a cotangent [1, N, heads, c]: as JAX arrays and torch
    tensors of the same bits."""
    rng = np.random.default_rng(seed)
    draws = [rng.standard_normal((1, N, heads, c)).astype(np.float32) for _ in range(4)]
    if dtype == "bf16":
        return [jnp.asarray(a, jnp.bfloat16) for a in draws], [torch.from_numpy(a).bfloat16() for a in draws]
    return [jnp.asarray(a) for a in draws], [torch.from_numpy(a) for a in draws]


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _assert_close(got, want, dtype, name):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, name
    limit = ULPS2 * np.abs(want).max() if dtype == "bf16" else ATOL
    err = np.abs(got - want).max()
    assert err <= limit, f"{name}: max |port - JAX| {err:.3e} > {limit:.3e}"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c,heads", CASES, ids=[f"c{c}" for c, _ in CASES])
def test_plain_forward_with_lse_matches_jax(c, heads, dtype):
    """out and lse of the plain K3a against the JAX package's K3a (with its
    lse); the isolated node's row exactly 0."""
    ids, masks, pairs = _layout()
    (jq, jk, jv, _), (q, k, v, _) = _draws(c + heads, c, heads, dtype)
    want, residuals = _clustered_fwd(jq, jk, jv, jnp.asarray(ids), jnp.asarray(masks), BLOCK, True, True)
    want_lse = np.asarray(residuals[-1]).reshape(1, ids.shape[0] * BLOCK, heads, 128)[..., 0]
    out, lse = clustered_flash_forward_reference(
        q, k, v, torch.from_numpy(ids), torch.from_numpy(masks), BLOCK, with_lse=True
    )
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    _assert_close(out, want, dtype, "out")
    real = want_lse > -1e27
    np.testing.assert_allclose(lse.numpy()[real], want_lse[real], atol=LSE_ATOL)
    assert bool((out[:, ISOLATED] == 0).all())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c,heads", CASES, ids=[f"c{c}" for c, _ in CASES])
def test_plain_symmetric_backward_matches_jax(c, heads, dtype):
    """dq, dk, dv of the port's autograd Function on the CPU (the plain
    forward with lse, then the plain K3c) against jax.vjp through the JAX
    package's clustered attention (its symmetric backward, or its general
    one where the symmetric kernels' working set does not fit), or, in f32
    at c = 768, its segment-softmax attention."""
    ids, masks, pairs = _layout()
    (jq, jk, jv, jcot), (q, k, v, cot) = _draws(10 * c + heads, c, heads, dtype)
    if dtype == "f32" and c > 512:  # the JAX kernels refuse it: the module docstring
        _, vjp = jax.vjp(lambda q, k, v: _segment_attention(q, k, v, pairs), jq, jk, jv)
    else:
        _, vjp = jax.vjp(
            lambda q, k, v: jax_clustered(
                q, k, v, jnp.asarray(ids), jnp.asarray(masks), BLOCK, interpret=True, symmetric=True
            ),
            jq, jk, jv,
        )
    want = vjp(jcot)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = clustered_flash_attention(
        *leaves, torch.from_numpy(ids), torch.from_numpy(masks), BLOCK, symmetric=True
    )
    got = torch.autograd.grad(out, leaves, cot)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == q.dtype
        _assert_close(a, b, dtype, f"d{name}")
    assert all(bool((g[:, ISOLATED] == 0).all()) for g in got)


def test_wide_heads_refused_before_any_launch():
    """K3a and K3c take heads up to 768; K3b's general backward stops at
    512 and K4a/K4b at 512, and each refuses a wider head in host code,
    before any launch (on the CPU a launch would first need nvcc), naming
    ROADMAP §2 item 4. The CPU wrapper runs the plain versions at any
    width."""
    clustered_flash.check_width(768, symmetric=True, backward=True)
    clustered_flash.check_width(768, symmetric=False)  # K3a alone
    clustered_flash.check_width(512, symmetric=False, backward=True)
    with pytest.raises(ValueError, match="§2 item 4"):
        clustered_flash.check_width(513, symmetric=False, backward=True)
    with pytest.raises(ValueError, match="head width 769 > 768"):
        clustered_flash.check_width(769)
    ids, masks = (torch.from_numpy(a) for a in _layout()[:2])
    q = torch.zeros(1, N, 1, 768)
    lse = torch.zeros(1, ids.shape[0] * BLOCK, 1)
    scatter = torch.zeros(N, 1, dtype=torch.int64)
    with pytest.raises(ValueError, match="§2 item 4"):
        clustered_flash._backward_cuda(q, q, q, ids, masks, q, lse, q, BLOCK, False, scatter)
    with pytest.raises(ValueError, match="head width 1024 > 768"):
        clustered_flash._forward_cuda(*(torch.zeros(1, N, 1, 1024),) * 3, ids, masks, BLOCK, False)
    band = torch.zeros(2, 512, 1536, dtype=torch.int8)
    wide = torch.zeros(1, 1000, 1, 768)
    with pytest.raises(ValueError, match="§2 item 4"):
        banded_flash._forward_cuda(wide, wide, wide, band, 512, 512, False)
    with pytest.raises(ValueError, match="§2 item 4"):
        banded_flash._backward_cuda(wide, wide, wide, band, wide, lse, wide, 512, 512)
    assert clustered_flash_attention(q, q, q, ids, masks, BLOCK).shape == q.shape
