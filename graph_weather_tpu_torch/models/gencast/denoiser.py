"""GenCast Denoiser: Karras-preconditioned encode-process-decode diffusion.

Port of graph_weather_tpu/models/gencast/denoiser.py:

    D(Z, X, sigma) = c_skip(sigma) Z + c_out(sigma) f_theta(c_in(sigma) Z, X, c_noise(sigma))

with f_theta = Encoder(g2m) -> noise-conditioned transformer Processor on
the k-hop mesh -> Decoder(m2g). Public tensors use the layout [B, lon, lat,
F]; inside, data is reordered to the graphs' lat-major node order (or
flattened lon-major with node_layout="reference", as the torch reference
does).

    den = Denoiser(grid_lon, grid_lat, 89, 83, splits=5, num_hops=4,
                   use_edges_features=False, attention_impl="clustered_flash")
    den.init(torch.Generator().manual_seed(0))
    denoised = den(corrupted, prev_inputs, noise_levels)   # on den.device

With attention_impl="clustered_flash" every processor block runs the CUDA
kernel K3a on the card (ops/clustered_flash.py); with "banded_flash" the
k-hop graph is lat-lon sorted and every block runs the banded kernel K4a
(ops/banded_flash.py); "banded" is the same band layout through plain
PyTorch (ops/banded_attention.py); "segment" is the segment-softmax path
with edge features. `apply` serves, under torch.no_grad(), in f32.
`forward_fn()` is the training forward: the same function with autograd,
whose attention backward runs K3c (or K3b), or K4b, on the card;
`remat=True` recomputes each transformer block in the backward.

`forward_fn(compute_dtype=torch.bfloat16)` is the JAX package's bf16
policy, for the clustered and segment attention: the network runs on bf16
copies of the f32 parameters (the gradients reach the f32 masters through
the cast), with bf16 inputs, static node features and edge features; the
noise levels, the preconditioning and the output stay f32. The clustered
attention then runs K3a, K3c and K3b in their bf16 mode on the card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from graph_weather_tpu_torch.models.gencast.graphs import build_graphcast_graphs
from graph_weather_tpu_torch.models.gencast.layers import (
    GenCastDecoder,
    GenCastEncoder,
    GenCastProcessor,
)
from graph_weather_tpu_torch.models.gencast.modules import GENCAST_TODO
from graph_weather_tpu_torch.nn.bf16 import f32_sums
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
from graph_weather_tpu_torch.nn.mlp import init_parameters


class Preconditioner:
    """Karras (2022) Table-1 preconditioning (sigma_data = 1 for GenCast)."""

    def __init__(self, sigma_data: float = 1.0):
        self.sigma_data = sigma_data

    def c_skip(self, sigma):
        return self.sigma_data**2 / (sigma**2 + self.sigma_data**2)

    def c_out(self, sigma):
        return sigma * self.sigma_data / torch.sqrt(sigma**2 + self.sigma_data**2)

    def c_in(self, sigma):
        return 1.0 / torch.sqrt(sigma**2 + self.sigma_data**2)

    def c_noise(self, sigma):
        return 0.25 * torch.log(sigma)


class DenoiserModule(nn.Module):
    """f_theta + preconditioning over [B, N, F] node data."""

    def __init__(
        self,
        input_features_dim: int,
        output_features_dim: int,
        grid_node_dim: int,
        mesh_node_dim: int,
        g2m_edge_dim: int,
        khop_edge_dim: int,
        m2g_edge_dim: int,
        hidden_dims: tuple[int, ...] = (512, 512),
        num_blocks: int = 16,
        num_heads: int = 4,
        use_edge_features: bool = True,
        scale_factor: float = 1.0,
        remat: bool = False,
    ):
        super().__init__()
        grid_dim = output_features_dim + 2 * input_features_dim + grid_node_dim
        self.GenCastEncoder_0 = GenCastEncoder(
            grid_dim, mesh_node_dim, g2m_edge_dim, hidden_dims, scale_factor=scale_factor
        )
        self.GenCastProcessor_0 = GenCastProcessor(
            latent_dim=hidden_dims[-1],
            hidden_dims=hidden_dims,
            num_blocks=num_blocks,
            num_heads=num_heads,
            edge_dim=khop_edge_dim,
            use_edge_features=use_edge_features,
            remat=remat,
        )
        self.GenCastDecoder_0 = GenCastDecoder(m2g_edge_dim, output_features_dim, hidden_dims)

    def forward(
        self,
        corrupted_targets: torch.Tensor,  # [B, N_grid, F_out]
        prev_inputs: torch.Tensor,  # [B, N_grid, 2 F_in]
        noise_levels: torch.Tensor,  # [B, 1]
        grid_node_feats: torch.Tensor,  # [N_grid, 3]
        mesh_node_feats: torch.Tensor,  # [N_mesh, 3]
        g2m: DeviceGraph,
        khop: DeviceGraph,
        m2g: DeviceGraph,
    ) -> torch.Tensor:
        precs = Preconditioner(sigma_data=1.0)
        batch = corrupted_targets.shape[0]
        dtype = corrupted_targets.dtype
        sigma = noise_levels[:, :, None]
        # The f32 factor is cast down, so that a bf16 policy stays bf16; the
        # output (f32 factors times bf16 values) is f32.
        grid_feats = torch.cat(
            [
                precs.c_in(sigma).to(dtype) * corrupted_targets,
                prev_inputs.to(dtype),
                grid_node_feats.to(dtype).expand((batch,) + grid_node_feats.shape),
            ],
            dim=-1,
        )
        latent_grid, latent_mesh = self.GenCastEncoder_0(grid_feats, mesh_node_feats, g2m)
        latent_mesh = self.GenCastProcessor_0(latent_mesh, precs.c_noise(noise_levels), khop)
        preds = self.GenCastDecoder_0(latent_mesh, latent_grid, m2g)
        return precs.c_skip(sigma) * corrupted_targets + precs.c_out(sigma) * preds


# Where GenCast's bf16 policy on the banded attention is queued.
BANDED_BF16_TODO = "ROADMAP.md, 'GenCast bf16 on the banded attention: K4a and K4b in bf16'"


def _not_ported(option: str, item: str = GENCAST_TODO) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported yet. See {item}.")


class Denoiser:
    """GenCast denoiser handle: builds the graphs, owns the nn.Module.

    Public tensors use the layout [B, lon, lat, F]. Runs on `device`
    ("cuda" unless the caller asks for "cpu").
    """

    def __init__(
        self,
        grid_lon: np.ndarray,
        grid_lat: np.ndarray,
        input_features_dim: int,
        output_features_dim: int,
        hidden_dims: tuple[int, ...] = (512, 512),
        num_blocks: int = 16,
        num_heads: int = 4,
        splits: int = 6,
        num_hops: int = 6,
        use_edges_features: bool = True,
        scale_factor: float = 1.0,
        remat: bool = False,
        attention_impl: str = "segment",
        mesh_orientation: str = "pole",
        node_layout: str = "consistent",
        device="cuda",
    ):
        if attention_impl not in ("segment", "banded", "banded_flash", "clustered_flash"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        if attention_impl != "segment" and use_edges_features:
            raise ValueError(
                f"attention_impl={attention_impl!r} requires use_edges_features=False "
                "(matching the reference's sparse attention mode, which also "
                "drops edge features)"
            )
        if node_layout not in ("consistent", "reference"):
            raise ValueError(f"unknown node_layout {node_layout!r}")
        self.node_layout = node_layout
        self.attention_impl = attention_impl
        self.num_lon = len(grid_lon)
        self.num_lat = len(grid_lat)
        self.input_features_dim = input_features_dim
        self.output_features_dim = output_features_dim
        self.device = torch.device(device)

        graphs = build_graphcast_graphs(
            grid_lon,
            grid_lat,
            splits=splits,
            num_hops=num_hops,
            add_edge_features_to_khop=use_edges_features,
            # Clustered attention wants compact geodesic receiver blocks;
            # the banded paths want small index spans (lat-lon sort).
            spatial_sort="rcb" if attention_impl == "clustered_flash" else True,
            mesh_orientation=mesh_orientation,
        )
        self.graphs = graphs
        self.g2m = DeviceGraph.from_bundle(graphs.g2m, self.device)
        self.khop = DeviceGraph.from_bundle(
            graphs.khop,
            self.device,
            clustered=attention_impl == "clustered_flash",
            banded=attention_impl.startswith("banded"),
            band_flash=attention_impl == "banded_flash",
        )
        self.m2g = DeviceGraph.from_bundle(graphs.m2g, self.device)
        self.grid_node_feats = torch.as_tensor(graphs.grid_node_feats, device=self.device)
        self.mesh_node_feats = torch.as_tensor(graphs.mesh_node_feats, device=self.device)

        self.module = DenoiserModule(
            input_features_dim=input_features_dim,
            output_features_dim=output_features_dim,
            grid_node_dim=graphs.grid_nodes_dim,
            mesh_node_dim=graphs.mesh_nodes_dim,
            g2m_edge_dim=graphs.g2m_edges_dim,
            khop_edge_dim=graphs.khop.edge_attr.shape[1],
            m2g_edge_dim=graphs.m2g_edges_dim,
            hidden_dims=tuple(hidden_dims),
            num_blocks=num_blocks,
            num_heads=num_heads,
            use_edge_features=use_edges_features,
            scale_factor=scale_factor,
            remat=remat,
        ).to(self.device)

    @classmethod
    def from_pretrained(cls, repo_id_or_path: str, **overrides):
        raise _not_ported(
            "Denoiser.from_pretrained",
            "ROADMAP.md, 'from_pretrained once the weights are in the repository'",
        )

    def init(self, generator: torch.Generator) -> dict:
        """Draw fresh torch-Linear-initialized weights from `generator` (a
        CPU generator: the same seed gives the same weights on any device).
        Returns the state_dict."""
        init_parameters(self.module, generator)
        return self.module.state_dict()

    # -- layout helpers: [B, lon, lat, F] <-> node order ----------------------
    # The graphs index grid nodes lat-major (node = lat_i * n_lon + lon_i);
    # node_layout="reference" flattens lon-major as the torch reference does
    # (against its own lat-major graphs), to reproduce the function that
    # weights trained with that quirk compute.
    def _to_nodes(self, x: torch.Tensor) -> torch.Tensor:
        b, lon, lat, f = x.shape
        if self.node_layout == "reference":
            return x.reshape(b, lon * lat, f)
        return x.permute(0, 2, 1, 3).reshape(b, lat * lon, f)

    def _from_nodes(self, x: torch.Tensor) -> torch.Tensor:
        b, _, f = x.shape
        if self.node_layout == "reference":
            return x.reshape(b, self.num_lon, self.num_lat, f)
        return x.reshape(b, self.num_lat, self.num_lon, f).permute(0, 2, 1, 3)

    def _check_shapes(self, corrupted_targets, prev_inputs, noise_levels):
        """Shape validation and the positivity of the noise levels (sigma <= 0
        would make c_noise = log(sigma) NaN silently)."""
        batch = prev_inputs.shape[0]
        exp_inputs = (batch, self.num_lon, self.num_lat, 2 * self.input_features_dim)
        exp_targets = (batch, self.num_lon, self.num_lat, self.output_features_dim)
        exp_noise = (batch, 1)
        if (
            tuple(corrupted_targets.shape) != exp_targets
            or tuple(prev_inputs.shape) != exp_inputs
            or tuple(noise_levels.shape) != exp_noise
        ):
            raise ValueError(
                "Input shapes don't match the initialization parameters: expected "
                f"{exp_inputs} for prev_inputs, {exp_targets} for targets and "
                f"{exp_noise} for noise_levels; got {tuple(prev_inputs.shape)}, "
                f"{tuple(corrupted_targets.shape)}, {tuple(noise_levels.shape)}."
            )
        if not bool((noise_levels > 0).all()):
            raise ValueError("All the noise levels must be strictly positive.")

    def forward_fn(self, compute_dtype=None):
        """The training forward: a differentiable callable
        (corrupted_targets, prev_inputs, noise_levels) -> denoised (f32),
        with the layouts of `apply`, on self.device. compute_dtype=
        torch.bfloat16 runs the network in bf16 (see the module docstring);
        None or torch.float32 in f32."""
        if compute_dtype in (None, torch.float32):
            return self._forward
        if compute_dtype != torch.bfloat16:
            raise _not_ported(f"compute_dtype={compute_dtype}")
        if self.attention_impl.startswith("banded"):
            raise _not_ported(
                f"compute_dtype=bfloat16 with attention_impl={self.attention_impl!r}",
                BANDED_BF16_TODO,
            )
        bf16 = torch.bfloat16
        graphs = (
            dataclasses.replace(g, edge_attr=g.edge_attr.to(bf16))
            for g in (self.g2m, self.khop, self.m2g)
        )
        consts = (self.grid_node_feats.to(bf16), self.mesh_node_feats.to(bf16), *graphs)

        def forward(corrupted_targets, prev_inputs, noise_levels):
            corrupted_targets, prev_inputs, noise_levels = (
                torch.as_tensor(t, dtype=torch.float32, device=self.device)
                for t in (corrupted_targets, prev_inputs, noise_levels)
            )
            self._check_shapes(corrupted_targets, prev_inputs, noise_levels)
            params = {name: p.to(bf16) for name, p in self.module.named_parameters()}
            args = (
                self._to_nodes(corrupted_targets.to(bf16)),
                self._to_nodes(prev_inputs.to(bf16)),
                noise_levels,
                *consts,
            )
            with f32_sums():  # the products sum in f32, as XLA's
                out = torch.func.functional_call(self.module, params, args)
            return self._from_nodes(out).float()

        return forward

    @torch.no_grad()
    def apply(self, corrupted_targets, prev_inputs, noise_levels, conditioning=None):
        """[B, lon, lat, F_out], [B, lon, lat, 2 F_in], [B, 1] -> denoised
        [B, lon, lat, F_out], on self.device (inputs are moved there)."""
        if conditioning is not None:
            raise _not_ported("conditioning (GenDA)", "ROADMAP.md §1 item 4, 'GenDA'")
        return self._forward(corrupted_targets, prev_inputs, noise_levels)

    def _forward(self, corrupted_targets, prev_inputs, noise_levels):
        corrupted_targets, prev_inputs, noise_levels = (
            torch.as_tensor(t, dtype=torch.float32, device=self.device)
            for t in (corrupted_targets, prev_inputs, noise_levels)
        )
        self._check_shapes(corrupted_targets, prev_inputs, noise_levels)
        out = self.module(
            self._to_nodes(corrupted_targets),
            self._to_nodes(prev_inputs),
            noise_levels,
            self.grid_node_feats,
            self.mesh_node_feats,
            self.g2m,
            self.khop,
            self.m2g,
        )
        return self._from_nodes(out)

    __call__ = apply


@dataclass
class DenoiserConfig:
    """Mirrors the JAX package's DenoiserConfig, plus the device."""

    grid_lon: np.ndarray
    grid_lat: np.ndarray
    input_features_dim: int
    output_features_dim: int
    hidden_dims: tuple = (512, 512)
    num_blocks: int = 16
    num_heads: int = 4
    splits: int = 6
    num_hops: int = 6
    use_edges_features: bool = True
    scale_factor: float = 1.0
    remat: bool = False
    attention_impl: str = "segment"
    device: str = "cuda"

    def build(self) -> Denoiser:
        return Denoiser(
            grid_lon=self.grid_lon,
            grid_lat=self.grid_lat,
            input_features_dim=self.input_features_dim,
            output_features_dim=self.output_features_dim,
            hidden_dims=tuple(self.hidden_dims),
            num_blocks=self.num_blocks,
            num_heads=self.num_heads,
            splits=self.splits,
            num_hops=self.num_hops,
            use_edges_features=self.use_edges_features,
            scale_factor=self.scale_factor,
            remat=self.remat,
            attention_impl=self.attention_impl,
            device=self.device,
        )
