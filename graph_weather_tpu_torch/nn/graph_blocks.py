"""MeshGraphNet-style message-passing blocks (port of graph_weather_tpu/nn/graph_blocks.py).

Blocks operate on [B, N, F] node / [E, F] or [B, E, F] edge features over a
static `DeviceGraph` shared across the batch. Semantics match the JAX
package (and the reference's graph_net_block.py):

  EdgeBlock:  e' = MLP([x_src, x_dst, e]) + e     (the fused K2 kernel)
  NodeBlock:  x' = MLP([x, sum_{e into x} e']) + x

Bipartite graphs update destination nodes only. Submodules carry the flax
auto-names (EdgeBlock_0/MLP_0/TorchLinear_0, ...) so converted parameters
load with a mechanical mapping (convert.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from graph_weather_tpu_torch.meshes.clustering import (
    build_cluster_layout,
    build_cluster_scatter_index,
    is_symmetric_edges,
)
from graph_weather_tpu_torch.meshes.graphs import GraphBundle
from graph_weather_tpu_torch.nn.mlp import OPTIONS_TODO, TorchLinear, make_norm
from graph_weather_tpu_torch.ops.banded_attention import build_band_masks
from graph_weather_tpu_torch.ops.fused_mlp import fused_edge_update
from graph_weather_tpu_torch.ops.scatter import (
    build_chunked_csr,
    build_padded_csr,
    chunked_csr_agg,
    padded_csr_agg,
    segment_sum_agg,
    table_owner,
)

# Degree threshold below which the padded-CSR (scatter-free) aggregation is
# used. Latent mesh (<=7) and mesh->grid (<=7) qualify; grid->mesh graphs on
# lat/lon grids have very skewed polar in-degrees and use segment_sum, unless
# the graph carries the edge_sums=True tables: then the aggregation, and the
# edge update's backward, sum through chunks of this width at any degree
# (grid->mesh receivers take up to 720 edges on a 1° grid, mesh->grid
# senders send up to 1,260).
_CSR_MAX_DEGREE = 16


def _sum_levels(ids: np.ndarray, n_nodes: int, device) -> tuple:
    """The levels of build_chunked_csr on `device`, each (edge_ids, mask,
    owner): owner the table row of each summed row (ops.scatter.table_owner)."""
    levels, n_items = [], ids.shape[0]
    for edge_ids, mask in build_chunked_csr(ids, n_nodes, _CSR_MAX_DEGREE):
        owner = table_owner(edge_ids, mask, n_items)
        levels.append(tuple(torch.as_tensor(a, device=device) for a in (edge_ids, mask, owner)))
        n_items = edge_ids.shape[0]  # the next level sums this level's rows
    return tuple(levels)


@dataclass(frozen=True)
class DeviceGraph:
    """A static graph resident on a device.

    The cluster_* fields (from_bundle(..., clustered=True)) carry the
    gathered-neighbour layout of the clustered attention kernel K3a
    (meshes/clustering.py, ops/clustered_flash.py): per block of
    `cluster_block` receivers, the union of their senders (`cluster_ids`,
    [nb, U_pad] int32, padding slots point at row 0) and the adjacency of
    the block's rows against that union (`cluster_masks`, [nb, block,
    U_pad] int8), whether the edge set is symmetric (`cluster_symmetric`:
    the attention backward then takes K3c) and, for an edge set that is
    not symmetric, the inverse of cluster_ids for K3b's gather-sum
    (`cluster_scatter`, meshes.clustering.build_cluster_scatter_index;
    None for a symmetric one).

    The band_* fields (from_bundle(..., banded=True)) carry the banded
    layout of a spatially sorted graph (ops/banded_attention.py,
    ops/banded_flash.py): receiver blocks of `band_block` rows against
    windows of band_block + 2 band_w key rows, through `band_masks`
    ([nb, block, block + 2w] int8), whether the attention runs the flash
    kernels K4a/K4b (`band_flash`) or the plain banded attention, and
    whether the edge set is symmetric (`band_symmetric`: K4b's dk/dv kernel
    then takes its symmetric role).

    receiver_sum and sender_sum (from_bundle(..., edge_sums=True): the
    forecaster's graphs) are the levels of padded CSR tables that sum edge
    rows to the receivers and to the senders: one table where no node has
    more than 16 edges (the csr_* table, with its owners), else two
    (ops.scatter.build_chunked_csr), each (edge_ids, mask, owner). The
    backward of EdgeBlock's fused edge update reads both; `aggregate` sums
    through receiver_sum, whose gradient is then a gather by the owners.
    """

    senders: torch.Tensor  # [E] int32
    receivers: torch.Tensor  # [E] int32, non-decreasing
    edge_attr: torch.Tensor  # [E, D] float32 precomputed features
    csr_edge_ids: Optional[torch.Tensor]  # [N_dst, K] int32 or None
    csr_mask: Optional[torch.Tensor]  # [N_dst, K] bool or None
    n_senders: int
    n_receivers: int
    receiver_sum: Optional[tuple] = None  # ((edge_ids, mask), ...) levels or None
    sender_sum: Optional[tuple] = None
    cluster_ids: Optional[torch.Tensor] = None  # [nb, U_pad] int32 or None
    cluster_masks: Optional[torch.Tensor] = None  # [nb, block, U_pad] int8 or None
    cluster_block: int = 0
    cluster_symmetric: bool = False
    cluster_scatter: Optional[torch.Tensor] = None  # [N_senders, K] int64 or None
    band_masks: Optional[torch.Tensor] = None  # [nb, block, block + 2w] int8 or None
    band_block: int = 0
    band_w: int = 0
    band_flash: bool = False
    band_symmetric: bool = False

    @classmethod
    def from_bundle(
        cls,
        bundle: GraphBundle,
        device="cuda",
        clustered: bool = False,
        cluster_block: int = 256,
        banded: bool = False,
        band_block: int = 512,
        band_flash: bool = False,
        edge_sums: bool = False,
    ) -> "DeviceGraph":
        # The CUDA kernels gather with these indices unchecked: check once here.
        for ids, bound, name in (
            (bundle.senders, bundle.n_senders, "senders"),
            (bundle.receivers, bundle.n_receivers, "receivers"),
        ):
            if ids.size and (ids.min() < 0 or ids.max() >= bound):
                raise ValueError(f"graph {name} out of range [0, {bound})")
        counts = np.bincount(bundle.receivers, minlength=bundle.n_receivers)
        use_csr = counts.size > 0 and counts.max() <= _CSR_MAX_DEGREE
        csr_ids = csr_mask = None
        if use_csr:
            ids, mask = build_padded_csr(bundle.receivers, bundle.n_receivers)
            csr_ids = torch.as_tensor(ids, device=device)
            csr_mask = torch.as_tensor(mask, device=device)
        receiver_sum = sender_sum = None
        if edge_sums:
            if use_csr:  # the receivers' one table is the csr_* table itself
                owner = torch.as_tensor(table_owner(ids, mask, bundle.n_edges), device=device)
                receiver_sum = ((csr_ids, csr_mask, owner),)
            else:
                receiver_sum = _sum_levels(bundle.receivers, bundle.n_receivers, device)
            sender_sum = _sum_levels(bundle.senders, bundle.n_senders, device)
        cluster_ids = cluster_masks = cluster_scatter = None
        cluster_symmetric = False
        if clustered:
            # Padding slots point at row 0, so the kernel needs a row 0.
            if bundle.n_senders < 1:
                raise ValueError("a clustered graph needs at least one sender")
            layout = build_cluster_layout(
                bundle.senders, bundle.receivers,
                bundle.n_receivers, bundle.n_senders, block=cluster_block,
            )
            cluster_ids = torch.as_tensor(layout.gather_ids, device=device)
            cluster_masks = torch.as_tensor(layout.masks.astype(np.int8), device=device)
            cluster_symmetric = bundle.n_senders == bundle.n_receivers and (
                is_symmetric_edges(bundle.senders, bundle.receivers)
            )
            if not cluster_symmetric:  # only K3b's gather-sum reads it
                cluster_scatter = torch.as_tensor(
                    build_cluster_scatter_index(layout.gather_ids, layout.masks, bundle.n_senders),
                    device=device,
                )
        band_masks, band_w = None, 0
        band_symmetric = False
        if banded:
            span = int(np.abs(
                bundle.senders.astype(np.int64) - bundle.receivers.astype(np.int64)
            ).max())
            # The JAX package's rounding, so that both lay out the same band:
            # its flash kernels' 512-key tiles divide the window and its
            # flash backward needs w in whole tiles; else a lane multiple.
            round_to = 512 if band_flash else 256
            band_w = -(-span // round_to) * round_to
            masks = build_band_masks(
                bundle.senders, bundle.receivers, bundle.n_receivers, block=band_block, w=band_w
            )
            band_masks = torch.as_tensor(masks.astype(np.int8), device=device)
            band_symmetric = bundle.n_senders == bundle.n_receivers and (
                is_symmetric_edges(bundle.senders, bundle.receivers)
            )
        senders, receivers, edge_attr = bundle.device_arrays(device)
        return cls(
            senders=senders,
            receivers=receivers,
            edge_attr=edge_attr,
            csr_edge_ids=csr_ids,
            csr_mask=csr_mask,
            n_senders=bundle.n_senders,
            n_receivers=bundle.n_receivers,
            receiver_sum=receiver_sum,
            sender_sum=sender_sum,
            cluster_ids=cluster_ids,
            cluster_masks=cluster_masks,
            cluster_block=cluster_block if clustered else 0,
            cluster_symmetric=cluster_symmetric,
            cluster_scatter=cluster_scatter,
            band_masks=band_masks,
            band_block=band_block if banded else 0,
            band_w=band_w,
            band_flash=banded and band_flash,
            band_symmetric=band_symmetric,
        )

    def aggregate(self, edge_feats: torch.Tensor) -> torch.Tensor:
        """Sum [..., E, F] edge features into [..., N_receivers, F]: through
        the receiver_sum levels where the graph carries them (in a fixed
        order at any degree, so the card repeats its bits), else the padded
        CSR table, else index_add_ (atomics on the card; GenCast's graphs,
        where two levels were slower)."""
        if self.receiver_sum is not None:
            return chunked_csr_agg(edge_feats, self.receiver_sum)
        if self.csr_edge_ids is not None:
            return padded_csr_agg(edge_feats, self.csr_edge_ids, self.csr_mask)
        return segment_sum_agg(edge_feats, self.receivers, self.n_receivers)


class _GatherSumLinear(TorchLinear):
    """One Linear over virtually-concatenated inputs, computed factorized.

    y = concat(parts) @ W + b  ==  sum_i (parts_i @ W_i)[gather_i] + b
    Stores ONE fused kernel [sum(widths), features] with torch-Linear init
    (the same parameter as a TorchLinear over the concatenation).
    """

    def __init__(self, widths: Sequence[int], features: int):
        super().__init__(sum(widths), features)
        self.widths = tuple(widths)

    def forward(self, parts) -> torch.Tensor:
        """parts: one (tensor_or_None, gather_index_or_None) per width.

        A None tensor skips its slice of the kernel, which is exact when that
        input is known to be all zeros.
        """
        y = None
        offset = 0
        for (tensor, idx), width in zip(parts, self.widths):
            if tensor is not None:
                t = tensor @ self.kernel[offset : offset + width]
                if idx is not None:
                    t = t.index_select(-2, idx)
                y = t if y is None else y + t
            offset += width
        return y + self.bias


class _FactorizedPartsMLP(nn.Module):
    """MLP over virtually-concatenated parts via _GatherSumLinear.

    Parameter names are those of `MLP` (TorchLinear_0..k + LayerNorm_0).
    """

    def __init__(
        self,
        widths: Sequence[int],
        out_dim: int,
        hidden_dim: int,
        hidden_layers: int,
        norm_type: Optional[str],
    ):
        super().__init__()
        self.hidden_layers = hidden_layers
        self.TorchLinear_0 = _GatherSumLinear(widths, hidden_dim)
        for i in range(1, hidden_layers):
            self.add_module(f"TorchLinear_{i}", TorchLinear(hidden_dim, hidden_dim))
        self.add_module(
            f"TorchLinear_{hidden_layers}", TorchLinear(hidden_dim, out_dim)
        )
        self.LayerNorm_0 = make_norm(norm_type, out_dim)

    def forward(self, parts) -> torch.Tensor:
        h = torch.relu(self.TorchLinear_0(parts))
        for i in range(1, self.hidden_layers):
            h = torch.relu(getattr(self, f"TorchLinear_{i}")(h))
        h = getattr(self, f"TorchLinear_{self.hidden_layers}")(h)
        return h if self.LayerNorm_0 is None else self.LayerNorm_0(h)


class EdgeBlock(nn.Module):
    """e' = MLP([x_src[s], x_dst[r], e]) + e, factorized as the JAX
    package's EdgeBlock: the first layer's node terms x_src @ Ws and
    x_dst @ Wd are taken once per node (torch.matmul, from row slices of
    MLP_0.TorchLinear_0.kernel), and one K2 launch (ops/fused_mlp.py)
    gathers them per edge and fuses e @ We, the other two products, the
    LayerNorm and the residual. Differentiable (K2b); it covers the
    two-hidden-layer edge MLP that every GraphWeatherForecaster uses.
    """

    def __init__(
        self,
        src_dim: int,
        dst_dim: int,
        edge_dim: int,
        hidden_dim: int = 128,
        hidden_layers: int = 2,
        norm_type: Optional[str] = "LayerNorm",
        dst_is_zero: bool = False,
    ):
        super().__init__()
        if hidden_layers != 2:
            raise NotImplementedError(
                f"EdgeBlock with hidden_layers={hidden_layers}: the fused edge "
                f"kernel takes 2. See {OPTIONS_TODO}."
            )
        self.dst_is_zero = dst_is_zero
        self.MLP_0 = _FactorizedPartsMLP(
            (src_dim, dst_dim, edge_dim), edge_dim, hidden_dim, 2, norm_type
        )

    def forward(
        self,
        x_src: torch.Tensor,
        x_dst: Optional[torch.Tensor],
        edge_feats: torch.Tensor,
        graph: DeviceGraph,
    ) -> torch.Tensor:
        mlp = self.MLP_0
        norm = mlp.LayerNorm_0
        kernel = mlp.TorchLinear_0.kernel
        f_src, f_dst, _ = mlp.TorchLinear_0.widths
        p_src = x_src @ kernel[:f_src]
        p_dst = None
        if not self.dst_is_zero:
            if x_dst.dim() == 3 and x_dst.stride(0) == 0:
                x_dst = x_dst[0]  # an expand()ed batch: one product, broadcast
            p_dst = x_dst @ kernel[f_src : f_src + f_dst]
        return fused_edge_update(
            graph.senders,
            graph.receivers,
            p_src,
            p_dst,
            edge_feats,
            kernel[f_src + f_dst :],
            mlp.TorchLinear_0.bias,
            mlp.TorchLinear_1.kernel,
            mlp.TorchLinear_1.bias,
            mlp.TorchLinear_2.kernel,
            mlp.TorchLinear_2.bias,
            None if norm is None else norm.weight,
            None if norm is None else norm.bias,
            sender_sum=graph.sender_sum,
            receiver_sum=graph.receiver_sum,
        )


class NodeBlock(nn.Module):
    """x' = MLP([x, aggregate(e')]) + x.

    With dst_is_zero the x contribution and the residual drop out exactly.
    """

    def __init__(
        self,
        node_dim: int,
        edge_dim: int,
        hidden_dim: int = 128,
        hidden_layers: int = 2,
        norm_type: Optional[str] = "LayerNorm",
        dst_is_zero: bool = False,
    ):
        super().__init__()
        self.dst_is_zero = dst_is_zero
        self.MLP_0 = _FactorizedPartsMLP(
            (node_dim, edge_dim), node_dim, hidden_dim, hidden_layers, norm_type
        )

    def forward(
        self,
        x_dst: Optional[torch.Tensor],
        edge_feats: torch.Tensor,
        graph: DeviceGraph,
    ) -> torch.Tensor:
        agg = graph.aggregate(edge_feats)
        if self.dst_is_zero:
            return self.MLP_0([(None, None), (agg, None)])
        return self.MLP_0([(x_dst, None), (agg, None)]) + x_dst


class GraphProcessorBlock(nn.Module):
    """One MetaLayer-equivalent round: edge update then node update.

    dst_is_zero marks x_dst as known all-zeros (the decoder's grid seed
    nodes): pass x_dst=None and the zero contributions are skipped exactly.
    """

    def __init__(
        self,
        node_dim: int,
        edge_dim: int,
        hidden_dim_node: int = 128,
        hidden_dim_edge: int = 128,
        hidden_layers_node: int = 2,
        hidden_layers_edge: int = 2,
        norm_type: Optional[str] = "LayerNorm",
        dst_is_zero: bool = False,
    ):
        super().__init__()
        self.EdgeBlock_0 = EdgeBlock(
            node_dim, node_dim, edge_dim, hidden_dim_edge, hidden_layers_edge,
            norm_type, dst_is_zero=dst_is_zero,
        )
        self.NodeBlock_0 = NodeBlock(
            node_dim, edge_dim, hidden_dim_node, hidden_layers_node, norm_type,
            dst_is_zero=dst_is_zero,
        )

    def forward(
        self,
        x_src: torch.Tensor,
        x_dst: Optional[torch.Tensor],
        edge_feats: torch.Tensor,
        graph: DeviceGraph,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        edge_feats = self.EdgeBlock_0(x_src, x_dst, edge_feats, graph)
        x_dst = self.NodeBlock_0(x_dst, edge_feats, graph)
        return x_dst, edge_feats


class GraphProcessor(nn.Module):
    """Stack of message-passing rounds on a homogeneous graph.

    `remat` checkpoints each block under autograd (torch.utils.checkpoint):
    the block's activations are recomputed in the backward instead of kept,
    as the JAX package's per-block nn.remat.
    """

    def __init__(
        self,
        num_blocks: int,
        node_dim: int,
        edge_dim: int,
        hidden_dim_node: int = 128,
        hidden_dim_edge: int = 128,
        hidden_layers_node: int = 2,
        hidden_layers_edge: int = 2,
        norm_type: Optional[str] = "LayerNorm",
        remat: bool = False,
    ):
        super().__init__()
        self.remat = remat
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(
                f"GraphProcessorBlock_{i}",
                GraphProcessorBlock(
                    node_dim, edge_dim, hidden_dim_node, hidden_dim_edge,
                    hidden_layers_node, hidden_layers_edge, norm_type,
                ),
            )

    def forward(
        self, x: torch.Tensor, edge_feats: torch.Tensor, graph: DeviceGraph
    ) -> tuple[torch.Tensor, torch.Tensor]:
        for i in range(self.num_blocks):
            block = getattr(self, f"GraphProcessorBlock_{i}")
            if self.remat and torch.is_grad_enabled():
                x, edge_feats = torch.utils.checkpoint.checkpoint(
                    block, x, x, edge_feats, graph, use_reentrant=False
                )
            else:
                x, edge_feats = block(x, x, edge_feats, graph)
        return x, edge_feats
