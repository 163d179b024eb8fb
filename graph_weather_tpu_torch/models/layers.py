"""Encode / Process / Decode layers of the hex-mesh forecaster.

Port of graph_weather_tpu/models/layers.py over batched [B, N, F] features
and static `DeviceGraph`s built once on the host. Bipartite updates touch
destination nodes only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graph_weather_tpu_torch.nn.graph_blocks import (
    DeviceGraph,
    GraphProcessor,
    GraphProcessorBlock,
)
from graph_weather_tpu_torch.nn.mlp import MLP, OPTIONS_TODO

EDGE_ATTR_DIM = 2  # [sin(d), cos(d)] of the great-circle edge length


class Encoder(nn.Module):
    """Grid -> hex-mesh encoder: node/edge embed + one bipartite MP round.

    The learnable per-cell seed features (`mesh_nodes`) are encoded by the
    same node MLP as the grid features, then one message-passing round pulls
    local grid information into each cell.

    Returns (mesh_latent [B, N_mesh, node_dim], latent_edge_feats
    [E_latent, edge_dim]); the latent edge features do not depend on the
    input, so they stay unbatched and the edge kernel broadcasts them.
    """

    def __init__(
        self,
        input_dim: int,
        node_dim: int = 256,
        edge_dim: int = 256,
        hidden_dim_processor_node: int = 256,
        hidden_dim_processor_edge: int = 256,
        hidden_layers_processor_node: int = 2,
        hidden_layers_processor_edge: int = 2,
        norm_type: Optional[str] = "LayerNorm",
        n_mesh: int = 5882,
    ):
        super().__init__()
        self.n_mesh = n_mesh
        self.node_dim = node_dim
        self.mesh_nodes = nn.Parameter(torch.zeros(n_mesh, input_dim))
        self.MLP_0 = MLP(
            input_dim, node_dim, hidden_dim_processor_node,
            hidden_layers_processor_node, norm_type,
        )
        self.MLP_1 = MLP(
            EDGE_ATTR_DIM, edge_dim, hidden_dim_processor_edge,
            hidden_layers_processor_edge, norm_type,
        )
        self.GraphProcessorBlock_0 = GraphProcessorBlock(
            node_dim, edge_dim, hidden_dim_processor_node,
            hidden_dim_processor_edge, hidden_layers_processor_node,
            hidden_layers_processor_edge, norm_type,
        )
        self.MLP_2 = MLP(
            EDGE_ATTR_DIM, edge_dim, hidden_dim_processor_edge,
            hidden_layers_processor_edge, norm_type,
        )

    def forward(
        self, features: torch.Tensor, g2m: DeviceGraph, latent: DeviceGraph
    ) -> tuple[torch.Tensor, torch.Tensor]:
        batch = features.shape[0]
        x_grid = self.MLP_0(features)  # [B, N_grid, node_dim]
        x_mesh = self.MLP_0(self.mesh_nodes).expand(batch, self.n_mesh, self.node_dim)
        edge_feats = self.MLP_1(g2m.edge_attr)  # [E, edge_dim], batch-broadcast
        x_mesh, _ = self.GraphProcessorBlock_0(x_grid, x_mesh, edge_feats, g2m)
        return x_mesh, self.MLP_2(latent.edge_attr)


class Processor(nn.Module):
    """num_blocks message-passing rounds on the latent hex-mesh graph."""

    def __init__(
        self,
        node_dim: int = 256,
        edge_dim: int = 256,
        num_blocks: int = 9,
        hidden_dim_processor_node: int = 256,
        hidden_dim_processor_edge: int = 256,
        hidden_layers_processor_node: int = 2,
        hidden_layers_processor_edge: int = 2,
        norm_type: Optional[str] = "LayerNorm",
        remat: bool = False,
        use_thermalizer: bool = False,
    ):
        super().__init__()
        if use_thermalizer:
            raise NotImplementedError(
                f"use_thermalizer is not ported yet. See {OPTIONS_TODO}."
            )
        self.GraphProcessor_0 = GraphProcessor(
            num_blocks, node_dim, edge_dim, hidden_dim_processor_node,
            hidden_dim_processor_edge, hidden_layers_processor_node,
            hidden_layers_processor_edge, norm_type, remat=remat,
        )

    def forward(
        self,
        x_mesh: torch.Tensor,  # [B, N_mesh, node_dim]
        latent_edge_feats: torch.Tensor,  # [E, edge_dim] or [B, E, edge_dim]
        latent: DeviceGraph,
    ) -> torch.Tensor:
        x_mesh, _ = self.GraphProcessor_0(x_mesh, latent_edge_feats, latent)
        return x_mesh


class Decoder(nn.Module):
    """Hex-mesh -> grid decoder: one bipartite MP round + output MLP.

    Grid destination nodes start as zeros, so the round runs with
    dst_is_zero: no receiver gather or x_dst product on the largest graph.
    The output MLP uses no norm. The forecast residual is the caller's.
    """

    def __init__(
        self,
        output_dim: int,
        node_dim: int = 256,
        edge_dim: int = 256,
        hidden_dim_processor_node: int = 256,
        hidden_dim_processor_edge: int = 256,
        hidden_layers_processor_node: int = 2,
        hidden_layers_processor_edge: int = 2,
        norm_type: Optional[str] = "LayerNorm",
        hidden_dim_decoder: int = 128,
        hidden_layers_decoder: int = 2,
    ):
        super().__init__()
        self.MLP_0 = MLP(
            EDGE_ATTR_DIM, edge_dim, hidden_dim_processor_edge, 2, norm_type
        )
        self.GraphProcessorBlock_0 = GraphProcessorBlock(
            node_dim, edge_dim, hidden_dim_processor_node,
            hidden_dim_processor_edge, hidden_layers_processor_node,
            hidden_layers_processor_edge, norm_type, dst_is_zero=True,
        )
        self.MLP_1 = MLP(
            node_dim, output_dim, hidden_dim_decoder, hidden_layers_decoder, None
        )

    def forward(self, x_mesh: torch.Tensor, m2g: DeviceGraph) -> torch.Tensor:
        edge_feats = self.MLP_0(m2g.edge_attr)  # [E, edge_dim], batch-broadcast
        x_grid, _ = self.GraphProcessorBlock_0(x_mesh, None, edge_feats, m2g)
        return self.MLP_1(x_grid)
