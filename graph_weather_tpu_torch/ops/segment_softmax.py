"""Segment softmax: attention over ragged graph neighbourhoods.

Port of graph_weather_tpu/ops/segment_softmax.py, which is XLA in the JAX
package, so plain PyTorch here. Logits live on edges; normalization groups
are receiver segments. Leading batch dims ([..., E, H]) share the indices.
"""

from __future__ import annotations

import torch


def _seg_reduce(edge_vals: torch.Tensor, receivers: torch.Tensor, n: int, reduce: str):
    """Reduce [..., E, H] over the edge axis into [..., n, H] by receiver."""
    shape = edge_vals.shape[:-2] + (n, edge_vals.shape[-1])
    if reduce == "amax":
        index = receivers.long().view(-1, 1).expand(edge_vals.shape)
        init = torch.full(shape, -torch.inf, dtype=edge_vals.dtype, device=edge_vals.device)
        return init.scatter_reduce(-2, index, edge_vals, "amax", include_self=True)
    out = torch.zeros(shape, dtype=edge_vals.dtype, device=edge_vals.device)
    return out.index_add_(-2, receivers, edge_vals)


def segment_softmax(
    logits: torch.Tensor, receivers: torch.Tensor, n_receivers: int
) -> torch.Tensor:
    """Numerically stable softmax over receiver segments.

    Args:
        logits: [..., E, H] per-edge, per-head attention logits.
        receivers: [E] sorted destination ids.
        n_receivers: number of destination nodes.

    Returns:
        [..., E, H] weights; each receiver's incoming edges sum to 1 per
        head, and receivers with no edges contribute nothing.
    """
    seg_max = _seg_reduce(logits, receivers, n_receivers, "amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    shifted = logits - seg_max.index_select(-2, receivers)
    exp = torch.exp(shifted)
    seg_sum = _seg_reduce(exp, receivers, n_receivers, "sum")
    denom = seg_sum.index_select(-2, receivers)
    return exp / torch.clamp(denom, min=1e-16)
