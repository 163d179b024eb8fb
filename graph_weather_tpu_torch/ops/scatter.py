"""Edge->node aggregation primitives (port of graph_weather_tpu/ops/scatter.py).

Both strategies are XLA in the JAX package, so they are plain PyTorch here:

  * `segment_sum_agg`: `index_add_` over the receiver ids. Works for any
    degree distribution (grid->mesh cells receive up to 720 grid points at
    the poles of a 1° grid). On CUDA the sum uses atomics, so its order,
    and the last bits of the result, change from run to run.
  * `padded_csr_agg`: for bounded-degree graphs (latent mesh and
    mesh->grid: <= 7) a dense [N, K] gather and masked sum, scatter-free
    and deterministic.
"""

from __future__ import annotations

import numpy as np
import torch


def segment_sum_agg(
    edge_feats: torch.Tensor, receivers: torch.Tensor, n_receivers: int
) -> torch.Tensor:
    """Sum [..., E, F] edge features into [..., N, F] by receiver id."""
    shape = edge_feats.shape[:-2] + (n_receivers, edge_feats.shape[-1])
    out = torch.zeros(shape, dtype=edge_feats.dtype, device=edge_feats.device)
    return out.index_add_(-2, receivers, edge_feats)


def padded_csr_agg(
    edge_feats: torch.Tensor, edge_ids: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Sum edge features via a padded CSR table.

    Args:
        edge_feats: [..., E, F].
        edge_ids: [N, K] int32 ids into the edge axis; padded entries may
            point anywhere (masked out).
        mask: [N, K] boolean validity.

    Returns:
        [..., N, F] aggregated features.
    """
    n, k = edge_ids.shape
    gathered = edge_feats.index_select(-2, edge_ids.reshape(-1))
    gathered = gathered.reshape(edge_feats.shape[:-2] + (n, k, edge_feats.shape[-1]))
    return (gathered * mask[..., None].to(edge_feats.dtype)).sum(dim=-2)


def build_padded_csr(receivers: np.ndarray, n_receivers: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: padded CSR (edge_ids [N, K], mask [N, K]) from sorted receivers.

    K = max in-degree. Padded ids are 0 (always masked).
    """
    receivers = np.asarray(receivers)
    counts = np.bincount(receivers, minlength=n_receivers)
    k = int(counts.max()) if counts.size else 0
    edge_ids = np.zeros((n_receivers, k), dtype=np.int32)
    # receivers is sorted, so filling valid row-major slots in order assigns
    # each node its contiguous run of edge ids.
    within = np.arange(k)[None, :] < counts[:, None]
    edge_ids[within] = np.arange(receivers.shape[0], dtype=np.int32)
    return edge_ids, within
