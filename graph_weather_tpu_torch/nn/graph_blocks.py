"""MeshGraphNet-style message-passing blocks (port of graph_weather_tpu/nn/graph_blocks.py).

Blocks operate on [B, N, F] node / [E, F] or [B, E, F] edge features over a
static `DeviceGraph` shared across the batch. Semantics match the JAX
package (and the reference's graph_net_block.py):

  EdgeBlock:  e' = MLP([x_src, x_dst, e]) + e     (the fused K1 kernel)
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
from torch import nn

from graph_weather_tpu_torch.meshes.graphs import GraphBundle
from graph_weather_tpu_torch.nn.mlp import OPTIONS_TODO, TorchLinear, make_norm
from graph_weather_tpu_torch.ops.edge_mlp import fused_edge_mlp
from graph_weather_tpu_torch.ops.scatter import (
    build_padded_csr,
    padded_csr_agg,
    segment_sum_agg,
)

# Degree threshold below which the padded-CSR (scatter-free) aggregation is
# used. Latent mesh (<=7) and mesh->grid (<=7) qualify; grid->mesh graphs on
# lat/lon grids have very skewed polar in-degrees and use segment_sum.
_CSR_MAX_DEGREE = 16


@dataclass(frozen=True)
class DeviceGraph:
    """A static graph resident on a device.

    The JAX package's banded and clustered attention layouts are not carried
    yet: they serve the GenCast slice.
    """

    senders: torch.Tensor  # [E] int32
    receivers: torch.Tensor  # [E] int32, non-decreasing
    edge_attr: torch.Tensor  # [E, D] float32 precomputed features
    csr_edge_ids: Optional[torch.Tensor]  # [N_dst, K] int32 or None
    csr_mask: Optional[torch.Tensor]  # [N_dst, K] bool or None
    n_senders: int
    n_receivers: int

    @classmethod
    def from_bundle(cls, bundle: GraphBundle, device="cpu") -> "DeviceGraph":
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
        senders, receivers, edge_attr = bundle.device_arrays(device)
        return cls(
            senders=senders,
            receivers=receivers,
            edge_attr=edge_attr,
            csr_edge_ids=csr_ids,
            csr_mask=csr_mask,
            n_senders=bundle.n_senders,
            n_receivers=bundle.n_receivers,
        )

    def aggregate(self, edge_feats: torch.Tensor) -> torch.Tensor:
        """Sum [..., E, F] edge features into [..., N_receivers, F]."""
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
    """e' = MLP([x_src[s], x_dst[r], e]) + e, as one K1 launch.

    K1 (ops/edge_mlp.py) fuses the gathers, the three products, the
    LayerNorm and the residual; it covers the two-hidden-layer edge MLP that
    every GraphWeatherForecaster uses.
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
        return fused_edge_mlp(
            graph.senders,
            graph.receivers,
            x_src,
            None if self.dst_is_zero else x_dst,
            edge_feats,
            mlp.TorchLinear_0.kernel,
            mlp.TorchLinear_0.bias,
            mlp.TorchLinear_1.kernel,
            mlp.TorchLinear_1.bias,
            mlp.TorchLinear_2.kernel,
            mlp.TorchLinear_2.bias,
            None if norm is None else norm.weight,
            None if norm is None else norm.bias,
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
    """Stack of message-passing rounds on a homogeneous graph."""

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
        if remat:
            raise NotImplementedError(
                f"remat (use_checkpointing) is a training option. See {OPTIONS_TODO}."
            )
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
            x, edge_feats = block(x, x, edge_feats, graph)
        return x, edge_feats
