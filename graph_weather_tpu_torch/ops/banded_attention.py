"""Banded dense attention for spatially sorted graph neighbourhoods (port of
graph_weather_tpu/ops/banded_attention.py).

After the mesh nodes are renumbered by (lat, lon) (`spatial_sort=True`),
every k-hop edge joins nodes whose indices differ by at most a few hundred
(splits 5, 4 hops: 790 of 10,242 nodes). Graph attention over such a graph
is banded attention: receiver blocks of `block` rows each attend to a
window of block + 2w key rows through a precomputed adjacency mask. Receiver
r of block i sees window slot j, which is key row s = i * block + j - w;
key rows outside [0, N) are zero rows.

`banded_graph_attention` is the plain PyTorch version of the JAX package's
`attention_impl="banded"` (XLA there); `attention_impl="banded_flash"` runs
the kernels of ops/banded_flash.py over the same masks. Edge features are
not supported, as in the reference's sparse attention mode.

bf16 (GenCast's compute policy): on bf16 q, k and v it rounds where XLA
rounds the JAX function's bf16 ops: the logits einsum (f32 sums, one
rounding), the division by sqrt of c taken in bf16, the bf16 minimum off
the band, the subtraction of the row max and the exp, the division by the
row sum floored at 1e-16 in bf16, and the output einsum. Not mirrored: the
order of XLA:CPU's bf16 row sum (PyTorch sums in f32 and rounds once),
and the rounding points of the softmax's backward (autograd's bf16 ops).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def build_band_masks(
    senders: np.ndarray,
    receivers: np.ndarray,
    n: int,
    block: int = 512,
    w: int = 1024,
) -> np.ndarray:
    """[nb, block, block + 2w] bool adjacency masks for banded attention.

    Raises if an edge's index span exceeds w (widen w, or sort the nodes).
    Parallel edges collapse to one mask bit, so the edge set must have no
    duplicates (k-hop graphs from boolean matrix powers have none).
    """
    span = np.abs(senders.astype(np.int64) - receivers.astype(np.int64))
    if span.max() > w:
        raise ValueError(
            f"edge index span {span.max()} exceeds band half-width {w}; "
            "increase w (nodes must be spatially sorted)"
        )
    nb = -(-n // block)
    masks = np.zeros((nb, block, block + 2 * w), dtype=bool)
    blk = receivers // block
    r_local = receivers - blk * block
    j = senders - blk * block + w  # window slot
    valid = (j >= 0) & (j < block + 2 * w)
    masks[blk[valid], r_local[valid], j[valid]] = True
    return masks


def band_windows(t: torch.Tensor, nb: int, block: int, w: int) -> torch.Tensor:
    """[..., N, h, c] -> [..., nb, block + 2w, h, c]: block i's window of key
    rows i * block - w .. i * block + block + w - 1, zero outside [0, N)."""
    n = t.shape[-3]
    t_p = F.pad(t, (0, 0, 0, 0, w, nb * block - n + w))
    rows = torch.arange(nb, device=t.device)[:, None] * block + torch.arange(
        block + 2 * w, device=t.device
    )
    return t_p.index_select(-3, rows.reshape(-1)).reshape(
        t.shape[:-3] + (nb, block + 2 * w) + t.shape[-2:]
    )


def banded_graph_attention(
    q: torch.Tensor,  # [..., N, h, c]
    k: torch.Tensor,
    v: torch.Tensor,
    band_masks: torch.Tensor,  # [nb, block, block + 2w] bool or int8
    block: int,
    w: int,
) -> torch.Tensor:
    """out[r] = sum_s softmax_s(q_r . k_s / sqrt(c)) v_s over the banded edge
    set, as the JAX package computes it: logits off an edge at the dtype's
    minimum, exp against the (detached) row max, masked terms zeroed, the sum
    floored at 1e-16. Receivers without a neighbour get exact zeros. Returns
    q's shape; differentiable through autograd."""
    *_, n, h, c = q.shape
    nb = band_masks.shape[0]
    edge = band_masks.bool()[:, None]  # [nb, 1, block, width]
    q_b = F.pad(q, (0, 0, 0, 0, 0, nb * block - n))
    q_b = q_b.reshape(q.shape[:-3] + (nb, block, h, c))
    k_win, v_win = band_windows(k, nb, block, w), band_windows(v, nb, block, w)
    if q.dtype == torch.bfloat16:
        out = _banded_bf16(q_b, k_win, v_win, edge, c)
    else:
        logits = torch.einsum("...brhc,...bjhc->...bhrj", q_b, k_win) / c**0.5
        logits = torch.where(edge, logits, torch.finfo(logits.dtype).min)
        m = logits.amax(-1, keepdim=True).detach()
        e = torch.where(edge, torch.exp(logits - m), 0.0)
        attn = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-16)
        out = torch.einsum("...bhrj,...bjhc->...brhc", attn, v_win)
    return out.reshape(q.shape[:-3] + (nb * block, h, c))[..., :n, :, :]


def _banded_bf16(q_b, k_win, v_win, edge, c):
    """banded_graph_attention's body on bf16 blocks, rounded as XLA rounds
    the JAX function's bf16 ops (see the module docstring). Returns
    [..., nb, block, h, c] in bf16."""
    bf16 = torch.bfloat16
    logits = torch.einsum("...brhc,...bjhc->...bhrj", q_b.float(), k_win.float()).to(bf16)
    logits = logits / torch.sqrt(torch.tensor(float(c), dtype=bf16, device=q_b.device))
    logits = torch.where(edge, logits, torch.finfo(bf16).min)
    m = logits.amax(-1, keepdim=True).detach()
    e = torch.where(edge, torch.exp(logits - m), 0.0)
    floor = torch.tensor(1e-16, dtype=bf16, device=q_b.device)
    attn = e / torch.maximum(e.sum(-1, keepdim=True), floor)
    return torch.einsum("...bhrj,...bjhc->...brhc", attn.float(), v_win.float()).to(bf16)
