"""FGN: the noise-vector-conditioned ensemble forecaster (port of
graph_weather_tpu/models/fgn/model.py).

GenCast's encoder (g2m) and decoder (m2g) around a processor whose
conditional norms read a random noise VECTOR (no Fourier embedding, no
noise level, no preconditioning): one member maps the state at t to the
state at t + 1 under one draw of the noise; an ensemble is a draw per
member. Public tensors use the layout [B, lon, lat, F].

    fgn = FunctionalGenerativeNetwork(grid_lon, grid_lat, 89, 83, 32,
                                      hidden_dims=(768, 768), num_blocks=24,
                                      splits=6, num_hops=6,
                                      use_edges_features=False,
                                      attention_impl="clustered_flash")
    fgn.init(torch.Generator().manual_seed(0))
    member = fgn.member_fn()                  # (prev, noise [B, 32]) -> next
    ens = fgn.forward_fn(8, member_chunk=1)(prev, torch.Generator("cuda"))

With attention_impl="clustered_flash" every processor block runs K3a on the
card, 23 at heads of hidden / num_heads channels and the last (heads
averaged) at c = hidden: 768 at bench.py's scale; its backward runs K3c
(ops/clustered_flash.py). The JAX package vmaps the members; here chunks
of `member_chunk` members run in turn, the members of a chunk folded into
the batch axis (the kernels take a batch, as the TPU kernel folds it into
its grid). Noise comes from an explicit torch.Generator, or is handed in
(`noise=`, [E, B, noise_dim]) so that both packages see the same draws.

`member_fn(compute_dtype=torch.bfloat16)` is the JAX package's bf16 policy,
GenCast's (models/gencast/denoiser.py): bf16 copies of the f32 parameters
through one flat cast (nn.bf16.Bf16Params), bf16 inputs, node and edge
features, the modules' rounding points, f32 output; unlike the denoiser's
noise level, the noise vector is cast to bf16, so the conditional norms'
scale and bias are bf16 products, each rounded.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
from torch import nn

from graph_weather_tpu_torch.models.gencast.denoiser import _not_ported
from graph_weather_tpu_torch.models.gencast.graphs import build_graphcast_graphs
from graph_weather_tpu_torch.models.gencast.layers import (
    FGNProcessor,
    GenCastDecoder,
    GenCastEncoder,
)
from graph_weather_tpu_torch.nn.bf16 import Bf16Params, f32_sums
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
from graph_weather_tpu_torch.nn.mlp import init_parameters
from graph_weather_tpu_torch.ops import banded_flash


class FGNModule(nn.Module):
    """One member's forward over [B, N, F] node data: state + noise vector
    -> prediction."""

    def __init__(
        self,
        input_features_dim: int,
        output_features_dim: int,
        noise_dim: int,
        grid_node_dim: int,
        mesh_node_dim: int,
        g2m_edge_dim: int,
        khop_edge_dim: int,
        m2g_edge_dim: int,
        hidden_dims: tuple[int, ...] = (768, 768),
        num_blocks: int = 24,
        num_heads: int = 4,
        use_edge_features: bool = True,
        scale_factor: float = 1.0,
        remat: bool = False,
    ):
        super().__init__()
        self.GenCastEncoder_0 = GenCastEncoder(
            input_features_dim + grid_node_dim, mesh_node_dim, g2m_edge_dim, hidden_dims,
            scale_factor=scale_factor,
        )
        self.FGNProcessor_0 = FGNProcessor(
            latent_dim=hidden_dims[-1],
            hidden_dims=hidden_dims,
            noise_dim=noise_dim,
            num_blocks=num_blocks,
            num_heads=num_heads,
            edge_dim=khop_edge_dim,
            use_edge_features=use_edge_features,
            remat=remat,
        )
        self.GenCastDecoder_0 = GenCastDecoder(m2g_edge_dim, output_features_dim, hidden_dims)

    def forward(
        self,
        prev_state: torch.Tensor,  # [B, N_grid, F_in]
        noise_vector: torch.Tensor,  # [B, noise_dim]
        grid_node_feats: torch.Tensor,  # [N_grid, 3]
        mesh_node_feats: torch.Tensor,  # [N_mesh, 3]
        g2m: DeviceGraph,
        khop: DeviceGraph,
        m2g: DeviceGraph,
    ) -> torch.Tensor:
        batch = prev_state.shape[0]
        grid_feats = torch.cat(
            [prev_state, grid_node_feats.expand((batch,) + grid_node_feats.shape)], dim=-1
        )
        latent_grid, latent_mesh = self.GenCastEncoder_0(grid_feats, mesh_node_feats, g2m)
        latent_mesh = self.FGNProcessor_0(latent_mesh, noise_vector, khop)
        return self.GenCastDecoder_0(latent_mesh, latent_grid, m2g)


@lru_cache(maxsize=2)
def _host_graphs(lon, lat, splits, num_hops, edge_features, attention_impl, mesh_orientation):
    """build_graphcast_graphs of these settings (lon, lat: tuples)."""
    return build_graphcast_graphs(
        np.asarray(lon),
        np.asarray(lat),
        splits=splits,
        num_hops=num_hops,
        add_edge_features_to_khop=edge_features,
        spatial_sort="rcb" if attention_impl == "clustered_flash" else True,
        mesh_orientation=mesh_orientation,
    )


@lru_cache(maxsize=4)
def _graphs(lon, lat, splits, num_hops, edge_features, attention_impl, mesh_orientation, device):
    """(host graphs, g2m, khop, m2g, grid node features, mesh node
    features) on `device`, the k-hop graph with the layout of
    `attention_impl`: built once for each setting and device, so that a
    second handle (a remat copy, a shallower one) reuses them; the handles
    only read them."""
    graphs = _host_graphs(lon, lat, splits, num_hops, edge_features, attention_impl,
                          mesh_orientation)
    khop = DeviceGraph.from_bundle(
        graphs.khop,
        device,
        clustered=attention_impl == "clustered_flash",
        banded=attention_impl.startswith("banded"),
        band_flash=attention_impl == "banded_flash",
    )
    return (
        graphs,
        DeviceGraph.from_bundle(graphs.g2m, device),
        khop,
        DeviceGraph.from_bundle(graphs.m2g, device),
        torch.as_tensor(graphs.grid_node_feats, device=device),
        torch.as_tensor(graphs.mesh_node_feats, device=device),
    )


def _chunks(num_ensemble: int, member_chunk: Optional[int]) -> int:
    """The chunk size (member_chunk, or every member at once)."""
    chunk = num_ensemble if member_chunk is None else member_chunk
    if chunk < 1 or num_ensemble % chunk:
        raise ValueError(f"member_chunk={member_chunk} must divide num_ensemble={num_ensemble}")
    return chunk


class FunctionalGenerativeNetwork:
    """FGN handle: builds the graphs, owns the nn.Module; [B, lon, lat, F_in]
    -> [B, E, lon, lat, F_out] ensembles. Runs on `device` ("cuda" unless
    the caller asks for "cpu"). Handles of one grid, mesh and attention on
    one device share their graphs (`_graphs`)."""

    def __init__(
        self,
        grid_lon: np.ndarray,
        grid_lat: np.ndarray,
        input_features_dim: int,
        output_features_dim: int,
        noise_dimension: int,
        hidden_dims: tuple[int, ...] = (768, 768),
        num_blocks: int = 24,
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
        if node_layout not in ("consistent", "reference"):
            raise ValueError(f"unknown node_layout {node_layout!r}")
        if attention_impl != "segment" and use_edges_features:
            raise ValueError(
                f"attention_impl={attention_impl!r} requires use_edges_features=False "
                "(banded attention carries no per-edge features; see "
                "ops/banded_attention.py)"
            )
        self.device = torch.device(device)
        latent = tuple(hidden_dims)[-1]
        if (attention_impl == "banded_flash" and self.device.type == "cuda"
                and latent > banded_flash.MAX_CHANNELS):
            # The last block's heads are `latent` wide: raise before any launch.
            raise _not_ported(
                f"attention_impl='banded_flash' at the last block's head width {latent} "
                f"> {banded_flash.MAX_CHANNELS}", banded_flash.WIDE_HEADS_TODO,
            )
        self.node_layout = node_layout
        self.attention_impl = attention_impl
        self.num_lon = len(grid_lon)
        self.num_lat = len(grid_lat)
        self.input_features_dim = input_features_dim
        self.output_features_dim = output_features_dim
        self.noise_dimension = noise_dimension

        (self.graphs, self.g2m, self.khop, self.m2g, self.grid_node_feats,
         self.mesh_node_feats) = _graphs(
            tuple(np.asarray(grid_lon, np.float64).tolist()),
            tuple(np.asarray(grid_lat, np.float64).tolist()),
            splits, num_hops, use_edges_features, attention_impl, mesh_orientation,
            str(self.device),
        )
        graphs = self.graphs
        self.module = FGNModule(
            input_features_dim=input_features_dim,
            output_features_dim=output_features_dim,
            noise_dim=noise_dimension,
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
        self._bf16 = None  # (bf16 constants, Bf16Params), made at the first bf16 member_fn

    def init(self, generator: torch.Generator) -> dict:
        """Draw fresh torch-Linear-initialized weights from `generator` (a
        CPU generator: the same seed gives the same weights on any device).
        Returns the state_dict."""
        init_parameters(self.module, generator)
        return self.module.state_dict()

    # -- layout helpers: [B, lon, lat, F] <-> node order (as the Denoiser's:
    # node_layout="reference" flattens lon-major against the lat-major graphs,
    # as the torch reference does) ------------------------------------------
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

    def _inputs(self, prev_state, noise_vector):
        prev_state, noise_vector = (
            torch.as_tensor(t, dtype=torch.float32, device=self.device)
            for t in (prev_state, noise_vector)
        )
        exp_state = (self.num_lon, self.num_lat, self.input_features_dim)
        if prev_state.dim() != 4 or tuple(prev_state.shape[1:]) != exp_state or tuple(
            noise_vector.shape
        ) != (prev_state.shape[0], self.noise_dimension):
            raise ValueError(
                f"expected prev_state [B, {', '.join(map(str, exp_state))}] and noise_vector "
                f"[B, {self.noise_dimension}]; got {tuple(prev_state.shape)} and "
                f"{tuple(noise_vector.shape)}"
            )
        return prev_state, noise_vector

    def member_fn(self, compute_dtype=None):
        """One member: a differentiable callable (prev_state [B, lon, lat,
        F_in], noise_vector [B, noise_dim]) -> [B, lon, lat, F_out], f32, on
        self.device. compute_dtype=torch.bfloat16 runs the network in bf16
        (see the module docstring); None or torch.float32 in f32."""
        if compute_dtype in (None, torch.float32):
            return self._member
        if compute_dtype != torch.bfloat16:
            raise _not_ported(f"compute_dtype={compute_dtype}")
        if self._bf16 is None:
            bf16 = torch.bfloat16
            graphs = tuple(
                dataclasses.replace(g, edge_attr=g.edge_attr.to(bf16))
                for g in (self.g2m, self.khop, self.m2g)
            )
            consts = (self.grid_node_feats.to(bf16), self.mesh_node_feats.to(bf16), *graphs)
            self._bf16 = (consts, Bf16Params(self.module))
        consts, params = self._bf16

        def member(prev_state, noise_vector):
            prev_state, noise_vector = self._inputs(prev_state, noise_vector)
            args = (
                self._to_nodes(prev_state.to(torch.bfloat16)),
                noise_vector.to(torch.bfloat16),
                *consts,
            )
            with f32_sums():  # the products sum in f32, as XLA's
                out = torch.func.functional_call(self.module, params(), args)
            return self._from_nodes(out).float()

        return member

    def _member(self, prev_state, noise_vector):
        prev_state, noise_vector = self._inputs(prev_state, noise_vector)
        out = self.module(
            self._to_nodes(prev_state),
            noise_vector,
            self.grid_node_feats,
            self.mesh_node_feats,
            self.g2m,
            self.khop,
            self.m2g,
        )
        return self._from_nodes(out)

    def _noise(self, num_ensemble, batch, generator, noise):
        """The members' noise vectors [E, B, noise_dim] on self.device: the
        given ones, else standard normal draws from `generator` (on its own
        device, so that a CPU generator gives the same draws on any device)."""
        shape = (num_ensemble, batch, self.noise_dimension)
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
            if tuple(noise.shape) != shape:
                raise ValueError(f"noise: expected {shape}, got {tuple(noise.shape)}")
            return noise
        if generator is None:
            raise ValueError("pass a torch.Generator, or the members' noise vectors")
        return torch.randn(shape, generator=generator, device=generator.device).to(self.device)

    def forward_fn(self, num_ensemble: int = 2, compute_dtype=None, member_chunk=None):
        """An ensemble: a callable (prev_state [B, lon, lat, F_in],
        generator=None, noise=None) -> [B, E, lon, lat, F_out]. Each member
        draws its noise vector [B, noise_dim] (or takes noise[e] of the
        given [E, B, noise_dim]); chunks of `member_chunk` members (all at
        once by default) run in turn, folded into the batch axis."""
        member = self.member_fn(compute_dtype)
        chunk = _chunks(num_ensemble, member_chunk)

        def fn(prev_state, generator=None, noise=None):
            prev_state = torch.as_tensor(prev_state, dtype=torch.float32, device=self.device)
            batch = prev_state.shape[0]
            z = self._noise(num_ensemble, batch, generator, noise)
            out = []
            for e0 in range(0, num_ensemble, chunk):
                states = prev_state.repeat(chunk, 1, 1, 1)  # member-major: [chunk * B, ...]
                pred = member(states, z[e0 : e0 + chunk].reshape(chunk * batch, -1))
                out.append(pred.reshape((chunk, batch) + pred.shape[1:]))
            return torch.cat(out).transpose(0, 1)

        return fn

    def ensemble_rollout_fn(
        self, num_ensemble: int = 2, num_steps: int = 1, compute_dtype=None, member_chunk=None
    ):
        """An autoregressive ensemble trajectory: a callable (prev_state,
        generator=None, noise=None) -> [B, E, T, lon, lat, F_out]. A member's
        noise vector is drawn once and held fixed over its T steps (a member
        is one functional perturbation); members advance in chunks, as in
        `forward_fn`. Needs output_features_dim == input_features_dim."""
        if self.output_features_dim != self.input_features_dim:
            raise ValueError(
                "autoregressive rollout needs output_features_dim "
                f"({self.output_features_dim}) == input_features_dim "
                f"({self.input_features_dim})"
            )
        member = self.member_fn(compute_dtype)
        chunk = _chunks(num_ensemble, member_chunk)

        def fn(prev_state, generator=None, noise=None):
            prev_state = torch.as_tensor(prev_state, dtype=torch.float32, device=self.device)
            batch = prev_state.shape[0]
            z = self._noise(num_ensemble, batch, generator, noise)
            out = []
            for e0 in range(0, num_ensemble, chunk):
                state = prev_state.repeat(chunk, 1, 1, 1)
                z_chunk = z[e0 : e0 + chunk].reshape(chunk * batch, -1)
                steps = []
                for _ in range(num_steps):
                    state = member(state, z_chunk)
                    steps.append(state.reshape((chunk, batch) + state.shape[1:]))
                out.append(torch.stack(steps, dim=2))  # [chunk, B, T, ...]
            return torch.cat(out).transpose(0, 1)

        return fn

    @torch.no_grad()
    def apply(self, prev_state, num_ensemble: int = 2, generator=None, noise=None):
        """Serve an ensemble in f32: [B, lon, lat, F_in] -> [B, E, lon, lat,
        F_out] on self.device (`forward_fn`, all members at once)."""
        return self.forward_fn(num_ensemble)(prev_state, generator, noise)

    __call__ = apply


@dataclass
class FunctionalGenerativeNetworkConfig:
    """Mirrors the JAX package's FunctionalGenerativeNetworkConfig, plus the
    device."""

    grid_lon: np.ndarray
    grid_lat: np.ndarray
    input_features_dim: int
    output_features_dim: int
    noise_dimension: int
    hidden_dims: tuple = (768, 768)
    num_blocks: int = 24
    num_heads: int = 4
    splits: int = 6
    num_hops: int = 6
    use_edges_features: bool = True
    scale_factor: float = 1.0
    remat: bool = False
    attention_impl: str = "segment"
    device: str = "cuda"

    def build(self) -> FunctionalGenerativeNetwork:
        return FunctionalGenerativeNetwork(
            **{f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        )
