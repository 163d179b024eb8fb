"""The clustered attention's gradient on the CPU: the port's autograd
Function (plain forward with lse, plain K3b/K3c backward) against jax.grad
of the JAX package's clustered_flash_attention, run as the JAX package's
own tests run it on the CPU (interpret=True).

The layout is a random graph on n = 1200 nodes in 256-row blocks (nb = 5,
80 padded rows), with three receivers that have no edge, and a symmetrised
copy whose node 7 has no edge at all. Inputs come from numpy with a seed.
Tolerance atol 3e-5: f32 sums over a few hundred products in another order
(the JAX package's own limit between its two backwards).
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
from graph_weather_tpu_torch.meshes.clustering import (
    build_cluster_layout,
    build_cluster_scatter_index,
    is_symmetric_edges,
)
from graph_weather_tpu_torch.ops import clustered_flash
from graph_weather_tpu_torch.ops.clustered_flash import (
    clustered_flash_attention,
    clustered_flash_backward_reference,
    clustered_flash_forward_reference,
    gather_sum,
)

torch.set_num_threads(1)
ATOL = 3e-5
N, HEADS, BLOCK = 1200, 2, 256
EMPTY = [0, 300, 1199]  # receivers without an edge in the directed graph
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
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, N, HEADS, c)).astype(np.float32) for _ in range(4)]


def _ids_masks(layout):
    return layout.gather_ids, layout.masks.astype(np.int8)


@pytest.mark.parametrize("symmetric", [False, True], ids=["general", "symmetric"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("c", [16, 32])
def test_gradients_match_jax(layouts, c, batch, symmetric):
    """dq, dk, dv of sum(out * cot): the port's autograd Function against
    jax.grad through the Pallas K3b (general) or K3c (symmetric) backward."""
    ids, masks = _ids_masks(layouts[symmetric])
    q, k, v, cot = _inputs(c + batch, batch, c)

    def loss(q, k, v):
        out = jax_clustered(
            q, k, v, jnp.asarray(ids), jnp.asarray(masks), BLOCK, interpret=True, symmetric=symmetric
        )
        return jnp.sum(out * cot)

    want = jax.grad(loss, (0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = clustered_flash_attention(
        tq, tk, tv, torch.from_numpy(ids), torch.from_numpy(masks), BLOCK, symmetric=symmetric
    )
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(cot))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=f"d{name}")
    if symmetric:
        assert all(bool((g[:, ISOLATED] == 0).all()) for g in got)
    else:
        assert bool((got[0][:, EMPTY] == 0).all())


@pytest.mark.parametrize("symmetric", [False, True], ids=["general", "symmetric"])
def test_plain_backward_matches_autograd_of_plain_forward(layouts, symmetric):
    """The written-out backward against torch.autograd of the plain forward,
    unbatched [N, h, c] and batched."""
    ids, masks = (torch.from_numpy(a) for a in _ids_masks(layouts[symmetric]))
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(5, 2, 16))
    for batch_slice in (0, slice(None)):
        qb, kb, vb, db = (t[batch_slice] for t in (q, k, v, dout))
        leaves = [t.clone().requires_grad_(True) for t in (qb, kb, vb)]
        out = clustered_flash_forward_reference(*leaves, ids, masks, BLOCK)
        want = torch.autograd.grad(out, leaves, db)
        out, lse = clustered_flash_forward_reference(qb, kb, vb, ids, masks, BLOCK, with_lse=True)
        got = clustered_flash_backward_reference(qb, kb, vb, ids, masks, out, lse, db, BLOCK, symmetric)
        for name, a, b in zip("qkv", got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("batch", [1, 2])
def test_lse_matches_jax(layouts, batch):
    """The forward's log-sum-exp [B, nb * block, h] against the residual of
    the JAX package's _clustered_fwd (its 128-lane broadcast, lane 0)."""
    ids, masks = _ids_masks(layouts[False])
    q, k, v, _ = _inputs(9, batch, 16)
    _, residuals = _clustered_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ids), jnp.asarray(masks), BLOCK, True, False
    )
    nb = ids.shape[0]
    want = np.asarray(residuals[-1]).reshape(batch, nb * BLOCK, HEADS, 128)[..., 0]
    _, lse = clustered_flash_forward_reference(
        *(torch.from_numpy(a) for a in (q, k, v, ids, masks)), BLOCK, with_lse=True
    )
    assert lse.shape == (batch, nb * BLOCK, HEADS)
    real = want > -1e27  # rows with a neighbour; the others hold -1e28 + log(1e-30)
    assert not real[:, EMPTY].any() and not real[:, N:].any()
    np.testing.assert_allclose(lse.numpy()[real], want[real], atol=ATOL)
    np.testing.assert_allclose(lse.numpy()[~real], want[~real], rtol=1e-6)


def test_symmetric_rejects_mismatched_node_sets(layouts):
    ids, masks = (torch.from_numpy(a) for a in _ids_masks(layouts[True]))
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 1, 8))
    with pytest.raises(ValueError, match="same node set"):
        clustered_flash_attention(q, k[:, :1100], v[:, :1100], ids, masks, BLOCK, symmetric=True)
    out, lse = clustered_flash_forward_reference(q, k, v, ids, masks, BLOCK, with_lse=True)
    with pytest.raises(ValueError, match="same node set"):
        clustered_flash_backward_reference(q, k[:, :1100], v[:, :1100], ids, masks, out, lse, q, BLOCK, True)


def test_cpu_backward_counts_no_launch(layouts):
    """On the CPU the Function runs the plain versions: no kernel counts move."""
    ids, masks = (torch.from_numpy(a) for a in _ids_masks(layouts[True]))
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _inputs(2, 1, 8)[:3])
    counts = lambda: (  # noqa: E731
        clustered_flash.LAUNCHES, clustered_flash.GENERAL_BWD_LAUNCHES,
        clustered_flash.SYMMETRIC_DQ_LAUNCHES, clustered_flash.SYMMETRIC_DKV_LAUNCHES,
    )
    before = counts()
    for symmetric in (False, True):
        clustered_flash_attention(q, k, v, ids, masks, BLOCK, symmetric=symmetric).sum().backward()
    assert counts() == before


def test_scatter_index_inverts_gather_ids(layouts):
    """gather_sum over build_cluster_scatter_index equals index_add_ over
    gather_ids, padding slots (all-zero mask columns) carrying zeros."""
    layout = layouts[False]
    index = build_cluster_scatter_index(layout.gather_ids, layout.masks, N)
    member = layout.masks.any(axis=1)
    assert index.shape[0] == N and index.dtype == np.int64
    assert np.bincount(index[index < member.size], minlength=member.size).tolist() == member.reshape(-1).astype(int).tolist()
    rng = np.random.default_rng(4)
    local = torch.from_numpy(rng.standard_normal((2,) + member.shape + (3, 4)).astype(np.float32))
    local = local * torch.from_numpy(member)[None, :, :, None, None]
    want = torch.zeros(2, N, 3, 4).index_add_(
        1, torch.from_numpy(layout.gather_ids.reshape(-1)).long(), local.reshape(2, -1, 3, 4)
    )
    got = gather_sum(local, torch.from_numpy(index), N + 80)  # + the processor's padded rows
    torch.testing.assert_close(got[:, :N], want, rtol=0, atol=1e-6)
    assert got.shape == (2, N + 80, 3, 4) and bool((got[:, N:] == 0).all())
