"""The plain PyTorch K3a and segment softmax against the JAX package, on the CPU.

The JAX kernel runs as the JAX package's own tests run it on the CPU, in
the Pallas interpreter (interpret=True). Inputs come from numpy with a
seed. Tolerance atol 2e-5: softmax-weighted sums in f32 that differ only in
summation order. Receivers without a neighbour, and padded rows, must come
out exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.ops.pallas.clustered_flash import (
    clustered_flash_attention as jax_clustered,
)
from graph_weather_tpu.ops.segment_softmax import segment_softmax as jax_segment_softmax
from graph_weather_tpu_torch.meshes.clustering import build_cluster_layout
from graph_weather_tpu_torch.ops import clustered_flash
from graph_weather_tpu_torch.ops.clustered_flash import (
    clustered_flash_attention,
    clustered_flash_forward_reference,
)
from graph_weather_tpu_torch.ops.scatter import build_flat_csr
from graph_weather_tpu_torch.ops.segment_softmax import segment_softmax

torch.set_num_threads(1)
ATOL = 2e-5


def _graph(rng, n, deg=6, empty=(3, 17)):
    """Random local graph, destination-sorted; `empty` receivers get no edge."""
    receivers = np.repeat(np.arange(n), deg)
    senders = (receivers + rng.integers(-30, 31, receivers.size)) % n
    keep = ~np.isin(receivers, empty)
    return senders[keep].astype(np.int32), receivers[keep].astype(np.int32)


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("batch", [1, 2])
def test_plain_clustered_matches_jax(c, batch):
    """n = 300 rows in 128-row blocks: 3 blocks, 84 padded rows; two
    receivers without a neighbour."""
    rng = np.random.default_rng(c + batch)
    n, h, block = 300, 2, 128
    s, r = _graph(rng, n)
    layout = build_cluster_layout(s, r, n, n, block=block)
    ids, masks = layout.gather_ids, layout.masks.astype(np.int8)
    q, k, v = (rng.standard_normal((batch, n, h, c)).astype(np.float32) for _ in range(3))
    want = np.asarray(
        jax_clustered(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ids),
            jnp.asarray(masks), block, interpret=True,
        )
    )
    got = clustered_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(ids), torch.from_numpy(masks), block,
    ).numpy()
    assert got.shape == (batch, n, h, c)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(got[:, [3, 17]] == 0.0)
    assert np.all(want[:, [3, 17]] == 0.0)


def test_plain_clustered_unbatched_and_padded_rows():
    """[N, h, c] inputs; q carrying the padded rows (as the processor passes
    them) gives exact zeros there and the unpadded answer elsewhere."""
    rng = np.random.default_rng(5)
    n, h, c, block = 200, 2, 8, 64
    s, r = _graph(rng, n)
    layout = build_cluster_layout(s, r, n, n, block=block)
    ids, masks = torch.from_numpy(layout.gather_ids), torch.from_numpy(layout.masks.astype(np.int8))
    n_pad = layout.n_blocks * block
    q, k, v = (torch.from_numpy(rng.standard_normal((n_pad, h, c)).astype(np.float32)) for _ in range(3))
    out = clustered_flash_forward_reference(q, k, v, ids, masks, block)
    assert out.shape == (n_pad, h, c)
    assert torch.all(out[n:] == 0) and torch.all(out[[3, 17]] == 0)
    short = clustered_flash_forward_reference(q[:n], k, v, ids, masks, block)
    assert torch.equal(short, out[:n])
    want = np.asarray(jax_clustered(*(jnp.asarray(t.numpy()) for t in (q, k, v, ids, masks)), block, interpret=True))
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL)


def test_cpu_wrapper_takes_plain_and_counts_nothing():
    rng = np.random.default_rng(2)
    s, r = _graph(rng, 64, empty=())
    layout = build_cluster_layout(s, r, 64, 64, block=32)
    args = [torch.from_numpy(rng.standard_normal((64, 1, 4)).astype(np.float32)) for _ in range(3)]
    ids, masks = torch.from_numpy(layout.gather_ids), torch.from_numpy(layout.masks.astype(np.int8))
    before = clustered_flash.LAUNCHES
    out = clustered_flash_attention(*args, ids, masks, 32)
    assert clustered_flash.LAUNCHES == before
    assert torch.equal(out, clustered_flash_forward_reference(*args, ids, masks, 32))
    with pytest.raises(TypeError, match="int8"):
        clustered_flash_attention(*args, ids, masks.bool(), 32)
    with pytest.raises(ValueError, match="nb \\* block"):
        clustered_flash_attention(*(a.repeat(2, 1, 1) for a in args), ids, masks, 32)
    with pytest.raises(ValueError, match="masks"):
        clustered_flash_attention(*args, ids, masks, 16)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["unbatched", "batched"])
def test_segment_softmax_matches_jax(lead):
    rng = np.random.default_rng(3)
    s, r = _graph(rng, 50)
    logits = (3.0 * rng.standard_normal(lead + (r.size, 4))).astype(np.float32)
    want = np.asarray(jax_segment_softmax(jnp.asarray(logits), jnp.asarray(r), 50))
    csr = [torch.from_numpy(a) for a in build_flat_csr(r, 50)]
    got = segment_softmax(torch.from_numpy(logits), torch.from_numpy(r), 50, csr).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    sums = torch.zeros(lead + (50, 4)).index_add_(-2, torch.from_numpy(r), torch.from_numpy(got))
    np.testing.assert_allclose(np.delete(sums.numpy(), [3, 17], axis=-2), 1.0, atol=1e-5)
