"""Segment softmax: attention over ragged graph neighbourhoods.

Port of graph_weather_tpu/ops/segment_softmax.py, which is XLA in the JAX
package, so plain PyTorch here. Logits live on edges; normalization groups
are receiver segments. Leading batch dims ([..., E, H]) share the indices.
bf16 logits stay bf16 throughout, every operation rounded as in the JAX
package. Over the receivers' flat CSR (a DeviceGraph's receiver_csr), the
segment sums run in edge order (ops.scatter.edge_order_sum: S, each partial
sum rounded in bf16) and the gathers back onto the edges have S as their
gradient, so every sum runs in a fixed order and the card repeats its bits
(the max is order-free).
"""

from __future__ import annotations

import torch

from graph_weather_tpu_torch.ops.scatter import edge_order_sum, gather_rows


def segment_softmax(
    logits: torch.Tensor,
    receivers: torch.Tensor,
    n_receivers: int,
    receiver_csr: tuple,
) -> torch.Tensor:
    """Numerically stable softmax over receiver segments.

    Args:
        logits: [..., E, H] per-edge, per-head attention logits.
        receivers: [E] sorted destination ids.
        n_receivers: number of destination nodes.
        receiver_csr: the receivers' flat CSR (ops.scatter.build_flat_csr,
            a DeviceGraph's receiver_csr): (offsets int32 [N + 1], edge ids
            int32 [E]).

    Returns:
        [..., E, H] weights; each receiver's incoming edges sum to 1 per
        head, and receivers with no edges contribute nothing.
    """
    shape = logits.shape[:-2] + (n_receivers, logits.shape[-1])
    index = receivers.long().view(-1, 1).expand(logits.shape)
    init = torch.full(shape, -torch.inf, dtype=logits.dtype, device=logits.device)
    seg_max = init.scatter_reduce(-2, index, logits, "amax", include_self=True)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    exp = torch.exp(logits - gather_rows(seg_max, receivers, receiver_csr))
    seg_sum = edge_order_sum(exp, *receiver_csr, nodes=receivers)
    denom = gather_rows(seg_sum, receivers, receiver_csr)
    return exp / torch.clamp(denom, min=1e-16)
