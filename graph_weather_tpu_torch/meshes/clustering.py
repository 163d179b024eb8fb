"""Geodesically-compact node clustering for block-sparse attention.

NumPy copy of graph_weather_tpu/meshes/clustering.py;
tests/test_torch_gencast_graphs.py holds the two bit-identical. The
port's K3a kernel is ops/clustered_flash.py + csrc/clustered_flash.cu.

The banded attention layout (ops/banded_attention.py) keys work off a
GLOBAL band half-width — the worst edge span. On a sphere, any 1D order
has Omega(sqrt(N))-wide spans, and with lat-lon sorting a 512-row receiver
block is a thin 360-degree strip whose k-hop neighborhood is the whole
band: at GenCast production scale (splits 6 / hops 6) each 512-receiver
block attends a 5,632-key window of which ~98% per row is masked out —
the kernel becomes VPU-bound on wasted softmax work (NOTES.md).

This module instead orders nodes by RECURSIVE COORDINATE BISECTION, so
every `block` consecutive receivers form a compact geodesic patch, and
precomputes, per block, the UNION of its rows' neighbors — approximately
the patch dilated by k hops: 1,286 keys max at splits 6 (4.4x smaller
than the band window). ops/pallas/clustered_flash.py then runs dense
masked flash attention of each receiver block against its gathered
neighbor set. Works for ARBITRARY static graphs (no bandedness needed).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def rcb_order(xyz: np.ndarray, leaf: int) -> np.ndarray:
    """Recursive coordinate bisection ordering of points.

    Splits along the widest coordinate axis at a leaf-aligned cut until
    parts have <= leaf points; concatenating the leaves gives an order in
    which every aligned `leaf`-sized slice is a compact patch. Returns the
    permutation `perm` such that xyz[perm] is the new order.
    """
    xyz = np.asarray(xyz)
    order: list[np.ndarray] = []

    def rec(ids: np.ndarray) -> None:
        if len(ids) <= leaf:
            order.append(ids)
            return
        p = xyz[ids]
        d = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        srt = ids[np.argsort(p[:, d], kind="stable")]
        if len(ids) > 2 * leaf:
            # Leaf-aligned halves keep every final block fully inside one
            # spatial cell (no straddling the cut).
            h = max(leaf, (len(ids) // 2 // leaf) * leaf)
        else:
            h = len(ids) // 2
        rec(srt[:h])
        rec(srt[h:])

    rec(np.arange(len(xyz), dtype=np.int64))
    return np.concatenate(order)


@dataclass(frozen=True)
class ClusterLayout:
    """Per-receiver-block gathered-neighbor attention layout.

    Attributes:
        gather_ids: [nb, U_pad] int32 global source rows per block; padding
            slots point at row 0 (always valid — no appended dummy row).
            Every padded slot's mask column is all-False, so the padded
            rows contribute exactly zero in both forward (softmax prob 0)
            and backward (dk/dv columns identically zero).
        masks: [nb, block, U_pad] bool adjacency of block-local receivers
            vs gathered sources.
        block: receiver rows per block.
        n_blocks / u_pad: layout dims.
    """

    gather_ids: np.ndarray
    masks: np.ndarray
    block: int

    @property
    def n_blocks(self) -> int:
        return self.gather_ids.shape[0]

    @property
    def u_pad(self) -> int:
        return self.gather_ids.shape[1]


def is_symmetric_edges(senders: np.ndarray, receivers: np.ndarray) -> bool:
    """True iff the edge set equals its transpose (i->j present iff j->i).

    Symmetric graphs (e.g. the k-hop mesh graph: powers of a symmetric
    adjacency) qualify for the scatter-free transpose backward in
    ops/pallas/clustered_flash.py."""
    fwd = np.unique(
        np.stack(
            [np.asarray(senders, np.int64), np.asarray(receivers, np.int64)],
            axis=1,
        ),
        axis=0,
    )
    rev = np.unique(
        np.stack(
            [np.asarray(receivers, np.int64), np.asarray(senders, np.int64)],
            axis=1,
        ),
        axis=0,
    )
    return fwd.shape == rev.shape and bool(np.array_equal(fwd, rev))


def build_cluster_layout(
    senders: np.ndarray,
    receivers: np.ndarray,
    n_receivers: int,
    n_senders: int,
    block: int = 512,
    kt: int = 128,
) -> ClusterLayout:
    """Build the gathered-neighbor layout for a destination-sorted graph.

    Nodes must already be ordered so that aligned `block`-slices of the
    receiver space are spatially compact (rcb_order); the layout itself is
    correct for any order, just larger.
    """
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if len(senders) and (senders.min() < 0 or senders.max() >= n_senders):
        raise ValueError(
            f"sender ids out of range [0, {n_senders}): "
            f"min={senders.min()}, max={senders.max()} — a malformed edge "
            "list would silently clamp inside jnp.take under jit"
        )
    nb = -(-n_receivers // block)
    blk = receivers // block
    order = np.argsort(blk, kind="stable")
    sb, bb = senders[order], blk[order]
    rb = receivers[order] - bb * block
    bounds = np.searchsorted(bb, np.arange(nb + 1))

    unions = [
        np.unique(sb[bounds[b] : bounds[b + 1]]) for b in range(nb)
    ]
    u_max = max((len(u) for u in unions), default=1)
    # Tight padding: the single-pass flash kernels need only 128-lane
    # alignment; at GenCast splits 5 this is U_pad 768 vs 1024 (-25%
    # gather/softmax work). The streaming fallbacks need kt=512.
    u_pad = max(-(-u_max // kt) * kt, kt)

    gather_ids = np.zeros((nb, u_pad), dtype=np.int32)
    masks = np.zeros((nb, block, u_pad), dtype=bool)
    for b, u in enumerate(unions):
        gather_ids[b, : len(u)] = u
        # Local slot of each edge's sender within the block's union.
        lo = bounds[b]
        hi = bounds[b + 1]
        slots = np.searchsorted(u, sb[lo:hi])
        masks[b, rb[lo:hi], slots] = True
    return ClusterLayout(gather_ids=gather_ids, masks=masks, block=block)


def build_cluster_scatter_index(
    gather_ids: np.ndarray, masks: np.ndarray, n_senders: int
) -> np.ndarray:
    """Inverse of a layout's gather_ids, for the general backward's
    deterministic gather-sum of block-local dk/dv back to global rows.

    Returns int64 [n_senders, K]: row n lists the flat positions
    b * U_pad + u of every union slot that holds sender n, in block order,
    padded with nb * U_pad (a zero row the caller appends). Padding slots
    (all-zero mask column) are left out: they carry exact zeros.
    """
    nb, u_pad = gather_ids.shape
    member = np.asarray(masks).astype(bool).any(axis=1).reshape(-1)
    pos = np.flatnonzero(member)
    ids = np.asarray(gather_ids).reshape(-1)[pos].astype(np.int64)
    order = np.argsort(ids, kind="stable")
    ids, pos = ids[order], pos[order]
    counts = np.bincount(ids, minlength=n_senders)
    starts = np.cumsum(counts) - counts
    index = np.full((n_senders, max(int(counts.max(initial=0)), 1)), nb * u_pad, np.int64)
    index[ids, np.arange(ids.size) - starts[ids]] = pos
    return index
