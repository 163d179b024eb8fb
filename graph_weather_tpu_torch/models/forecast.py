"""GraphWeatherForecaster: the Keisler-2022 global forecast model in PyTorch.

Port of graph_weather_tpu/models/forecast.py. Takes `lat_lons` at
construction, builds all graphs on the host (NumPy), moves them to
`device`, and maps [B, N, feature+aux] states to [B, N, output] next states
via hex-mesh encode -> message passing -> decode with an input residual.

    model = GraphWeatherForecaster(lat_lons, device="cuda")
    model.init(torch.Generator().manual_seed(0))
    prediction = model(features)          # features on model.device

Serving: `apply` (and `model(...)`) runs under torch.no_grad(). Training:
`forward_fn()` is the differentiable features -> prediction, for
`train.make_train_step(model.module.parameters(), model.forward_fn(), loss,
make_optimizer(lr))`; `use_checkpointing=True` recomputes each processor
block in the backward. `forward_fn(compute_dtype=torch.bfloat16)` is the JAX
package's bf16 policy (see forward_fn). The cached static edge features are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from graph_weather_tpu_torch.meshes.graphs import (
    GraphBundle,
    build_grid_to_mesh_graph,
    build_latent_graph,
    build_mesh_to_grid_graph,
)
from graph_weather_tpu_torch.meshes.hexmesh import get_hexmesh
from graph_weather_tpu_torch.models.layers import Decoder, Encoder, Processor
from graph_weather_tpu_torch.nn.bf16 import Bf16Params, f32_sums
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
from graph_weather_tpu_torch.nn.mlp import OPTIONS_TODO, init_parameters
from graph_weather_tpu_torch.utils import validate_lat_lons

TF32_TODO = "ROADMAP.md, 'TF32 compute policy'"


class ForecasterModule(nn.Module):
    """Encode-process-decode module; graphs passed as arguments."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        node_dim: int = 256,
        edge_dim: int = 256,
        num_blocks: int = 9,
        hidden_dim_processor_node: int = 256,
        hidden_dim_processor_edge: int = 256,
        hidden_layers_processor_node: int = 2,
        hidden_layers_processor_edge: int = 2,
        hidden_dim_decoder: int = 128,
        hidden_layers_decoder: int = 2,
        norm_type: Optional[str] = "LayerNorm",
        n_mesh: int = 5882,
        remat: bool = False,
        constraint_type: str = "none",
        use_thermalizer: bool = False,
    ):
        super().__init__()
        if constraint_type != "none":
            raise NotImplementedError(
                f"constraint_type={constraint_type!r} is not ported yet. "
                f"See {OPTIONS_TODO}."
            )
        self.output_dim = output_dim
        processor_kw = dict(
            node_dim=node_dim,
            edge_dim=edge_dim,
            hidden_dim_processor_node=hidden_dim_processor_node,
            hidden_dim_processor_edge=hidden_dim_processor_edge,
            hidden_layers_processor_node=hidden_layers_processor_node,
            hidden_layers_processor_edge=hidden_layers_processor_edge,
            norm_type=norm_type,
        )
        self.Encoder_0 = Encoder(input_dim=input_dim, n_mesh=n_mesh, **processor_kw)
        self.Processor_0 = Processor(
            num_blocks=num_blocks, remat=remat, use_thermalizer=use_thermalizer,
            **processor_kw,
        )
        self.Decoder_0 = Decoder(
            output_dim=output_dim,
            hidden_dim_decoder=hidden_dim_decoder,
            hidden_layers_decoder=hidden_layers_decoder,
            **processor_kw,
        )

    def forward(
        self,
        features: torch.Tensor,  # [B, N_grid, feature_dim + aux_dim]
        g2m: DeviceGraph,
        latent: DeviceGraph,
        m2g: DeviceGraph,
    ) -> torch.Tensor:
        x_mesh, latent_edge_feats = self.Encoder_0(features, g2m, latent)
        x_mesh = self.Processor_0(x_mesh, latent_edge_feats, latent)
        out = self.Decoder_0(x_mesh, m2g)
        # Residual: predict the tendency, add the current state. Under the
        # bf16 policy in f32: the add's only use is the f32 output, and XLA
        # computes such an add in f32.
        state = features[..., : self.output_dim]
        if out.dtype == torch.bfloat16:
            return out.float() + state.float()
        return out + state


def reversal_conjugated_latent(bundle: GraphBundle) -> GraphBundle:
    """Map both endpoints of a latent graph through rho(i) = N-1-i.

    The reference's encoder/decoder index H3 rows in reversed sorted-cell
    order while its latent processor graph is built ascending, so converted
    reference weights reproduce the reference net function only on this
    conjugated graph (`latent_graph_order="reference"`)."""
    n = bundle.n_senders
    return GraphBundle(
        senders=(n - 1 - bundle.senders).astype(np.int32),
        receivers=(n - 1 - bundle.receivers).astype(np.int32),
        edge_attr=bundle.edge_attr,
        n_senders=n,
        n_receivers=n,
    ).sorted_by_receiver()


class GraphWeatherForecaster:
    """Forecast model handle: owns the static graphs and the nn.Module."""

    def __init__(
        self,
        lat_lons: list,
        resolution: int = 2,
        feature_dim: int = 78,
        aux_dim: int = 24,
        output_dim: Optional[int] = None,
        node_dim: int = 256,
        edge_dim: int = 256,
        num_blocks: int = 9,
        hidden_dim_processor_node: int = 256,
        hidden_dim_processor_edge: int = 256,
        hidden_layers_processor_node: int = 2,
        hidden_layers_processor_edge: int = 2,
        hidden_dim_decoder: int = 128,
        hidden_layers_decoder: int = 2,
        norm_type: str = "LayerNorm",
        use_checkpointing: bool = False,
        constraint_type: str = "none",
        use_thermalizer: bool = False,
        latent_graph_order: str = "native",
        device="cuda",
    ):
        validate_lat_lons(lat_lons)
        if latent_graph_order not in ("native", "reference"):
            raise ValueError(
                f"latent_graph_order must be 'native' or 'reference', got "
                f"{latent_graph_order!r}"
            )
        self.lat_lons = list(lat_lons)
        self.feature_dim = feature_dim
        self.aux_dim = aux_dim
        self.output_dim = feature_dim if output_dim is None else output_dim
        self.device = torch.device(device)

        mesh = get_hexmesh(resolution)
        ll = np.asarray(self.lat_lons, dtype=np.float64)
        latent = build_latent_graph(mesh)
        if latent_graph_order == "reference":
            latent = reversal_conjugated_latent(latent)
        self.g2m = DeviceGraph.from_bundle(
            build_grid_to_mesh_graph(ll, mesh), self.device, edge_sums=True
        )
        self.latent = DeviceGraph.from_bundle(latent, self.device, edge_sums=True)
        self.m2g = DeviceGraph.from_bundle(
            build_mesh_to_grid_graph(ll, mesh), self.device, edge_sums=True
        )

        self.module = ForecasterModule(
            input_dim=feature_dim + aux_dim,
            output_dim=self.output_dim,
            node_dim=node_dim,
            edge_dim=edge_dim,
            num_blocks=num_blocks,
            hidden_dim_processor_node=hidden_dim_processor_node,
            hidden_dim_processor_edge=hidden_dim_processor_edge,
            hidden_layers_processor_node=hidden_layers_processor_node,
            hidden_layers_processor_edge=hidden_layers_processor_edge,
            hidden_dim_decoder=hidden_dim_decoder,
            hidden_layers_decoder=hidden_layers_decoder,
            norm_type=norm_type,
            n_mesh=mesh.num_cells,
            remat=use_checkpointing,
            constraint_type=constraint_type,
            use_thermalizer=use_thermalizer,
        ).to(self.device)
        self._bf16 = None  # (bf16 graphs, Bf16Params), made at the first bf16 forward_fn

    @property
    def num_grid_nodes(self) -> int:
        return len(self.lat_lons)

    def init(self, generator: torch.Generator) -> dict:
        """Draw fresh torch-Linear-initialized weights from `generator` (a
        CPU generator: the same seed gives the same weights on any device).
        Returns the state_dict."""
        init_parameters(self.module, generator)
        with torch.no_grad():
            self.module.Encoder_0.mesh_nodes.zero_()
        return self.module.state_dict()

    def forward_fn(self, compute_dtype=None):
        """The differentiable forward, features [B, N, feature+aux] ->
        prediction [B, N, output], over this handle's graphs and weights (the
        counterpart of the JAX package's forward_fn(params, features): here
        the parameters are `self.module.parameters()`).

        compute_dtype=torch.bfloat16 is the JAX package's bf16 policy: the
        parameters (bf16 copies through one flat cast, nn.bf16.Bf16Params:
        kept while they are unchanged when serving, in the autograd graph
        when training, so the f32 parameters get f32 gradients), the
        features and every graph's edge_attr (cast once per handle) are
        bf16; the modules round where XLA rounds the JAX package's run
        (nn/mlp.py, nn/graph_blocks.py) and the edge updates run the bf16
        kernels; the output is f32. None or torch.float32 run in f32; other
        dtypes raise."""
        module, g2m, latent, m2g = self.module, self.g2m, self.latent, self.m2g
        if compute_dtype in (None, torch.float32):

            def fn(features: torch.Tensor) -> torch.Tensor:
                return module(features, g2m, latent, m2g)

            return fn
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError(
                f"compute_dtype={compute_dtype}: the port runs float32 and bfloat16. See {TF32_TODO}."
            )
        if self._bf16 is None:
            graphs = tuple(
                dataclasses.replace(g, edge_attr=g.edge_attr.to(torch.bfloat16))
                for g in (g2m, latent, m2g)
            )
            self._bf16 = (graphs, Bf16Params(module))
        graphs, params = self._bf16

        def fn16(features: torch.Tensor) -> torch.Tensor:
            with f32_sums():  # the products sum in f32, as XLA's
                out = torch.func.functional_call(
                    module, params(), (features.to(torch.bfloat16), *graphs)
                )
            return out.float()

        return fn16

    @torch.no_grad()
    def apply(self, features: torch.Tensor) -> torch.Tensor:
        """Forward pass: [B, N, feature+aux] -> [B, N, output]."""
        return self.module(features, self.g2m, self.latent, self.m2g)

    __call__ = apply
