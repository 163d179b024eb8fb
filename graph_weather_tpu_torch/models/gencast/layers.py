"""GenCast encoder / processor / decoder (port of
graph_weather_tpu/models/gencast/layers.py).

Data layout is [B, N, F] with graphs shared across the batch. Under the
bf16 policy the activations are bf16 and the noise embedding f32
(modules.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.utils.checkpoint
from torch import nn

from graph_weather_tpu_torch.models.gencast.modules import (
    CondTransformerBlock,
    FourierEmbedding,
    GenCastMLP,
    InteractionNetwork,
    cluster_pad_rows,
    cluster_unpad_rows,
)
from graph_weather_tpu_torch.nn.bf16 import silu
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph


class GenCastEncoder(nn.Module):
    """Embed grid/mesh/edge features, one g2m interaction step + residuals."""

    def __init__(
        self,
        grid_dim: int,
        mesh_dim: int,
        edge_dim: int,
        hidden_dims: Sequence[int],
        scale_factor: float = 1.0,
    ):
        super().__init__()
        latent = hidden_dims[-1]
        self.GenCastMLP_0 = GenCastMLP(grid_dim, hidden_dims)
        self.GenCastMLP_1 = GenCastMLP(mesh_dim, hidden_dims)
        self.GenCastMLP_2 = GenCastMLP(edge_dim, hidden_dims)
        self.InteractionNetwork_0 = InteractionNetwork(
            latent, latent, latent, hidden_dims, scale_factor
        )
        self.GenCastMLP_3 = GenCastMLP(latent, hidden_dims)

    def forward(
        self,
        grid_nodes: torch.Tensor,  # [B, N_grid, grid_dim]
        mesh_nodes: torch.Tensor,  # [N_mesh, mesh_dim]
        g2m: DeviceGraph,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        batch = grid_nodes.shape[0]
        grid_emb = self.GenCastMLP_0(grid_nodes)
        mesh_emb = self.GenCastMLP_1(mesh_nodes)
        if mesh_emb.dim() == 2:
            mesh_emb = mesh_emb.expand((batch,) + mesh_emb.shape)
        edges_emb = self.GenCastMLP_2(g2m.edge_attr)  # shared by the batch
        latent_mesh = mesh_emb + self.InteractionNetwork_0(grid_emb, mesh_emb, edges_emb, g2m)
        latent_grid = grid_emb + self.GenCastMLP_3(grid_emb)
        return latent_grid, latent_mesh


class GenCastProcessor(nn.Module):
    """num_blocks noise-conditioned transformer blocks on the k-hop mesh.

    All blocks concatenate heads except the last, which averages them and
    drops the activation. Rows are padded once to the clustered layout
    (a no-op for the segment layout) and sliced once at the end. With
    `remat`, each block's activations are recomputed in the backward
    (torch.utils.checkpoint, the JAX package's nn.remat per block), with
    the parameters the forward used (the bf16 copies under
    Denoiser.forward_fn's bf16 policy, not the f32 masters).

    The blocks' conditional norms read the FourierEmbedding of the noise
    level (GenCast), or, with `cond_dim`, a raw conditioning vector of that
    width (FGN's noise vector: FGNProcessor).
    """

    NOISE_EMB_DIM = 16

    def __init__(
        self,
        latent_dim: int,
        hidden_dims: Sequence[int],
        num_blocks: int = 16,
        num_heads: int = 4,
        edge_dim: int = 0,
        use_edge_features: bool = True,
        remat: bool = False,
        cond_dim: Optional[int] = None,
    ):
        super().__init__()
        if latent_dim % num_heads != 0:
            raise ValueError("latent_dim must be divisible by num_heads")
        self.num_blocks = num_blocks
        self.remat = remat
        if cond_dim is None:
            self.FourierEmbedding_0 = FourierEmbedding(self.NOISE_EMB_DIM)
            cond_dim = self.NOISE_EMB_DIM
        else:
            self.FourierEmbedding_0 = None
        use_edges = use_edge_features and edge_dim > 0
        self.GenCastMLP_0: Optional[GenCastMLP] = (
            GenCastMLP(edge_dim, hidden_dims) if use_edges else None
        )
        edge_emb_dim = hidden_dims[-1] if use_edges else None
        for i in range(num_blocks):
            last = i == num_blocks - 1
            self.add_module(
                f"CondTransformerBlock_{i}",
                CondTransformerBlock(
                    latent_dim,
                    out_channels=latent_dim if last else latent_dim // num_heads,
                    num_heads=num_heads,
                    cond_dim=cond_dim,
                    concat=not last,
                    use_edge_features=use_edges,
                    edge_dim=edge_emb_dim,
                    activation=None if last else silu,
                ),
            )

    def forward(
        self,
        latent_mesh: torch.Tensor,  # [B, N_mesh, latent]
        noise: torch.Tensor,  # [B, 1] log-scaled noise levels, or [B, cond_dim]
        khop: DeviceGraph,
    ) -> torch.Tensor:
        if self.FourierEmbedding_0 is not None:
            noise = self.FourierEmbedding_0(noise)
        cond = noise[:, None, :]  # broadcast over nodes
        edge_attr = None
        if self.GenCastMLP_0 is not None:
            edge_attr = self.GenCastMLP_0(khop.edge_attr)
        n_real = latent_mesh.shape[-2]
        latent_mesh = cluster_pad_rows(latent_mesh, khop)
        for i in range(self.num_blocks):
            block = getattr(self, f"CondTransformerBlock_{i}")
            if self.remat and torch.is_grad_enabled():
                state = dict(block.named_parameters())

                def run(*args, block=block, state=state):
                    return torch.func.functional_call(block, state, args)

                latent_mesh = torch.utils.checkpoint.checkpoint(
                    run, latent_mesh, khop, edge_attr, cond, use_reentrant=False
                )
            else:
                latent_mesh = block(latent_mesh, khop, edge_attr, cond)
        return cluster_unpad_rows(latent_mesh, n_real)


class FGNProcessor(GenCastProcessor):
    """FGN's processor (graph_weather_tpu/models/fgn/model.py: FGNProcessor):
    GenCast's block stack with the conditional norms reading the raw noise
    vector [B, noise_dim] (no Fourier embedding)."""

    def __init__(
        self,
        latent_dim: int,
        hidden_dims: Sequence[int],
        noise_dim: int,
        num_blocks: int = 24,
        num_heads: int = 4,
        edge_dim: int = 0,
        use_edge_features: bool = True,
        remat: bool = False,
    ):
        super().__init__(
            latent_dim, hidden_dims, num_blocks, num_heads, edge_dim, use_edge_features, remat,
            cond_dim=noise_dim,
        )


class GenCastDecoder(nn.Module):
    """One m2g interaction step + residual, then the output MLP."""

    def __init__(self, edge_dim: int, output_dim: int, hidden_dims: Sequence[int]):
        super().__init__()
        latent = hidden_dims[-1]
        self.GenCastMLP_0 = GenCastMLP(edge_dim, hidden_dims)
        self.InteractionNetwork_0 = InteractionNetwork(latent, latent, latent, hidden_dims)
        out_dims = tuple(hidden_dims[:-1]) + (output_dim,)
        self.GenCastMLP_1 = GenCastMLP(latent, out_dims)

    def forward(
        self,
        latent_mesh: torch.Tensor,  # [B, N_mesh, latent]
        latent_grid: torch.Tensor,  # [B, N_grid, latent]
        m2g: DeviceGraph,
    ) -> torch.Tensor:
        edges_emb = self.GenCastMLP_0(m2g.edge_attr)  # shared by the batch
        latent_grid = latent_grid + self.InteractionNetwork_0(
            latent_mesh, latent_grid, edges_emb, m2g
        )
        return self.GenCastMLP_1(latent_grid)
