"""Segment softmax: attention over ragged graph neighbourhoods.

Port of graph_weather_tpu/ops/segment_softmax.py, which is XLA in the JAX
package, so plain PyTorch here. Logits live on edges; normalization groups
are receiver segments. Leading batch dims ([..., E, H]) share the indices.
bf16 logits stay bf16 throughout, every operation rounded as in the JAX
package; their segment sums run in edge order, each partial sum rounded
(ops.scatter.segment_sum_bf16, over the receivers' flat CSR).
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_weather_tpu_torch.ops.scatter import segment_sum_agg, segment_sum_bf16


def segment_softmax(
    logits: torch.Tensor,
    receivers: torch.Tensor,
    n_receivers: int,
    receiver_csr: Optional[tuple] = None,
) -> torch.Tensor:
    """Numerically stable softmax over receiver segments.

    Args:
        logits: [..., E, H] per-edge, per-head attention logits.
        receivers: [E] sorted destination ids.
        n_receivers: number of destination nodes.
        receiver_csr: the receivers' flat CSR (ops.scatter.build_flat_csr,
            a DeviceGraph's receiver_csr): (offsets int32 [N + 1], edge ids
            int32 [E]). Needed for bf16 logits.

    Returns:
        [..., E, H] weights; each receiver's incoming edges sum to 1 per
        head, and receivers with no edges contribute nothing.
    """
    shape = logits.shape[:-2] + (n_receivers, logits.shape[-1])
    index = receivers.long().view(-1, 1).expand(logits.shape)
    init = torch.full(shape, -torch.inf, dtype=logits.dtype, device=logits.device)
    seg_max = init.scatter_reduce(-2, index, logits, "amax", include_self=True)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    shifted = logits - seg_max.index_select(-2, receivers)
    exp = torch.exp(shifted)
    if exp.dtype == torch.bfloat16:
        if receiver_csr is None:
            raise ValueError("segment_softmax: bf16 logits need the receivers' flat CSR")
        seg_sum = segment_sum_bf16(exp, *receiver_csr, nodes=receivers)
    else:
        seg_sum = segment_sum_agg(exp, receivers, n_receivers)
    denom = seg_sum.index_select(-2, receivers)
    return exp / torch.clamp(denom, min=1e-16)
