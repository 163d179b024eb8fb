"""Core MLP with MeshGraphNet semantics (port of graph_weather_tpu/nn/mlp.py).

`hidden_layers` ReLU-activated hidden layers, a linear output layer, then an
optional normalization applied to the output. Kernels are kept as
[in, out], as in the JAX package, so the converter is a renaming and the
CUDA kernels stream weight rows without a transpose. Initialization matches
torch.nn.Linear's default (uniform +-1/sqrt(fan_in) for kernel and bias),
drawn from an explicit `torch.Generator` by `init_parameters`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# Where each option the port does not run yet is queued.
OPTIONS_TODO = "ROADMAP.md, 'Forecaster options not yet ported'"


class TorchLinear(nn.Module):
    """y = x @ kernel (+ bias), with kernel [in, out] and torch-Linear init."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / self.kernel.shape[0] ** 0.5
        for p in (self.kernel, self.bias):
            if p is None:
                continue
            draw = torch.rand(p.shape, generator=generator, dtype=torch.float32)
            p.copy_((draw * 2.0 - 1.0) * bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


def make_norm(norm_type: Optional[str], dim: int) -> Optional[nn.Module]:
    """LayerNorm (eps 1e-5, torch's and the JAX package's) or None."""
    if norm_type is None or norm_type == "none":
        return None
    if norm_type == "LayerNorm":
        return nn.LayerNorm(dim, eps=1e-5)
    raise NotImplementedError(
        f"norm_type={norm_type!r} is not ported yet; only LayerNorm and None "
        f"are. See {OPTIONS_TODO}."
    )


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize every TorchLinear of `module` from `generator`, in module
    order; norms get scale 1 and bias 0. Draws on the CPU and copies, so a
    seed gives the same weights on every device."""
    for sub in module.modules():
        if isinstance(sub, TorchLinear):
            sub.reset_parameters(generator)
        elif isinstance(sub, nn.LayerNorm):
            sub.reset_parameters()


class MLP(nn.Module):
    """ReLU MLP with optional post-output normalization.

    Structure for hidden_layers=L: TorchLinear(hidden) + ReLU, repeated L
    times, then TorchLinear(out), then the optional norm. Submodules are
    named after the flax auto-names (TorchLinear_i, LayerNorm_0).
    """

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        hidden_dim: int = 128,
        hidden_layers: int = 2,
        norm_type: Optional[str] = "LayerNorm",
    ):
        super().__init__()
        self.hidden_layers = hidden_layers
        width = in_dim
        for i in range(hidden_layers):
            self.add_module(f"TorchLinear_{i}", TorchLinear(width, hidden_dim))
            width = hidden_dim
        self.add_module(f"TorchLinear_{hidden_layers}", TorchLinear(width, out_dim))
        self.LayerNorm_0 = make_norm(norm_type, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.hidden_layers):
            x = torch.relu(getattr(self, f"TorchLinear_{i}")(x))
        x = getattr(self, f"TorchLinear_{self.hidden_layers}")(x)
        return x if self.LayerNorm_0 is None else self.LayerNorm_0(x)
