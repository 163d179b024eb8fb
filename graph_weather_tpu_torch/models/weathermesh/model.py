"""WeatherMesh-3: residual conv encode -> 3D neighborhood-attention
processors -> decode. Port of graph_weather_tpu/models/weathermesh/model.py.

A 2D surface path and a 3D pressure path of residual downsampling conv
blocks merge into a latent [B, D, H, W, C] volume (the pressure levels plus
the surface as one more depth slice), processed by stacks of 3D
neighborhood attention; the decoder mirrors it with upsampling blocks. One
processor per timestep; a forecast step applies every processor once, and
`forecast_steps` repeats that in a Python loop (the JAX package's nn.scan:
the same weights either way).

    wm = WeatherMesh(timesteps=[6], surface_channels=8, pressure_channels=4,
                     pressure_levels=13, latent_dim=128, kernel=(3, 5, 5),
                     num_heads=4)                        # device="cuda"
    wm.init(torch.Generator().manual_seed(0))
    out = wm(surface, pressure)          # [B, H, W, C2], [B, D, H, W, C3]

Inputs and outputs are channels-last, as in the JAX package; the convs run
channels-first inside. Submodules carry the reference torch WeatherMesh's
names and torch-native weight layouts (encoder.surface_path.{i}.conv1,
bn_down, to_latent, transformer_layers.{i}.{qkv,proj,rpb},
processors.{p}.layers.{i}, decoder.split, ...), so its state_dict loads
with `load_state_dict` as it is; the `bn*` names stay when the norm is a
GroupNorm. On the card every attention layer runs impl="auto" of
ops/neighborhood_attention.py: the halo-tiled CUDA kernel K5a (and K5b in
the backward), or the wide-head K6 where K5a's tiles do not fit in shared
memory (heads wider than 128 channels, or of 96 or 128 at kernel (5, 7, 7),
as at latent_dim 768 with 8 heads), whose backward is K6b: such a model
trains on the card through `forward_fn` too.

On CPU tensors every conv runs in PyTorch's own CPU kernels, forward and
backward, never oneDNN's: on the H100 hosts (torch 2.11+cu128) oneDNN's CPU
conv backward gave a weight gradient off by its own size now and then, and
glibc heap aborts. The flag that picks the kernels is global and read when
each kernel runs, so `_CpuConv` turns oneDNN off around the backward too.
"""

from __future__ import annotations

import contextlib
from dataclasses import asdict, dataclass
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from graph_weather_tpu_torch.ops.neighborhood_attention import neighborhood_attention_3d


class _RunningBatchNorm(nn.modules.batchnorm._NormBase):
    """BatchNorm that always normalizes with its running statistics (the JAX
    package's use_running_average=True), in training too; state_dict keys
    as nn.BatchNorm2d/3d's."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps
        )


def _norm(channels: int, kind: str = "group") -> nn.Module:
    """Conv-path normalization: "group" (default), GroupNorm(min(32, c),
    eps 1e-5); "batch", inference-mode BatchNorm on stored running stats,
    eps 1e-5, which reproduces converted reference checkpoints."""
    if kind == "batch":
        return _RunningBatchNorm(channels)
    if kind != "group":
        raise ValueError(f"unknown norm {kind!r}")
    return nn.GroupNorm(min(32, channels), channels, eps=1e-5)


@contextlib.contextmanager
def _without_onednn():
    before = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = before


class _CpuConv(torch.autograd.Function):
    """A zero-padded convolution of CPU tensors with oneDNN off in its forward
    and in its backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        zeros = [0] * len(stride)
        with _without_onednn():
            out = torch.ops.aten.convolution(
                x, weight, bias, stride, padding, dilation, False, zeros, groups
            )
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, dilation, groups, bias is not None)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups, has_bias = ctx.conf
        wanted = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], has_bias and ctx.needs_input_grad[2]]
        with _without_onednn():
            dx, dw, db = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if has_bias else None, stride, padding,
                dilation, False, [0] * len(stride), groups, wanted,
            )
        return dx, dw, db, None, None, None, None


class _NativeCpuConv:
    """Mixin for nn.Conv2d/nn.Conv3d: CPU tensors take _CpuConv; CUDA
    tensors cuDNN, as the plain module."""

    def _conv_forward(self, input, weight, bias):
        if input.device.type != "cpu":
            return super()._conv_forward(input, weight, bias)
        if self.padding_mode != "zeros" or isinstance(self.padding, str):
            raise NotImplementedError("the CPU conv takes integer zero padding only")
        return _CpuConv.apply(
            input, weight, bias, list(self.stride), list(self.padding), list(self.dilation),
            self.groups,
        )


class _Conv2d(_NativeCpuConv, nn.Conv2d):
    pass


class _Conv3d(_NativeCpuConv, nn.Conv3d):
    pass


def _conv(ndim: int, *args, **kwargs) -> nn.Module:
    return (_Conv3d if ndim == 3 else _Conv2d)(*args, **kwargs)


class NeighborhoodAttention3D(nn.Module):
    """qkv projection + clamped-window 3D attention + rpb + out projection,
    over channels-last [B, D, H, W, C]."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        kernel_size: Sequence[int] = (5, 7, 7),
        circular_w: bool = False,
    ):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.num_heads = num_heads
        self.kernel_size = tuple(kernel_size)
        self.circular_w = circular_w
        kd, kh, kw = self.kernel_size
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.rpb = nn.Parameter(torch.zeros(num_heads, 2 * kd - 1, 2 * kh - 1, 2 * kw - 1))
        self.proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        heads = self.num_heads
        q, k, v = (
            t.reshape(b, d, h, w, heads, c // heads) for t in self.qkv(x).chunk(3, dim=-1)
        )
        out = neighborhood_attention_3d(q, k, v, self.kernel_size, self.rpb, self.circular_w)
        return self.proj(out.reshape(b, d, h, w, c))


class ConvDownBlock(nn.Module):
    """Residual downsampling conv block, 2D or 3D, channels-first. Padding
    k//2 on both sides (torch's, not XLA's SAME at stride 2)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        is_3d: bool = False,
        kernel_size: int = 3,
        stride=2,
        norm: str = "group",
    ):
        super().__init__()
        ndim = 3 if is_3d else 2
        pad = kernel_size // 2
        self.conv1 = _conv(ndim, in_channels, out_channels, kernel_size, padding=pad, bias=False)
        self.bn1 = _norm(out_channels, norm)
        self.conv2 = _conv(
            ndim, out_channels, out_channels, kernel_size, stride=stride, padding=pad, bias=False
        )
        self.bn2 = _norm(out_channels, norm)
        self.downsample = _conv(ndim, in_channels, out_channels, 1, stride=stride, bias=False)
        self.bn_down = _norm(out_channels, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.bn_down(self.downsample(x))
        out = F.gelu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.gelu(out + identity)


class ConvUpBlock(nn.Module):
    """Residual upsampling conv block, channels-first: a half-pixel-centred
    (bi/tri)linear x2 resize of H and W (depth kept), then the convs."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        is_3d: bool = False,
        kernel_size: int = 3,
        scale_factor: int = 2,
        norm: str = "group",
    ):
        super().__init__()
        ndim = 3 if is_3d else 2
        pad = kernel_size // 2
        self.scale = (1, scale_factor, scale_factor) if is_3d else (scale_factor, scale_factor)
        self.mode = "trilinear" if is_3d else "bilinear"
        self.upsample = _conv(ndim, in_channels, out_channels, 1, bias=False)
        self.bn_up = _norm(out_channels, norm)
        self.conv1 = _conv(ndim, in_channels, in_channels, kernel_size, padding=pad, bias=False)
        self.bn1 = _norm(in_channels, norm)
        self.conv2 = _conv(ndim, in_channels, out_channels, kernel_size, padding=pad, bias=False)
        self.bn2 = _norm(out_channels, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=self.scale, mode=self.mode, align_corners=False)
        identity = self.bn_up(self.upsample(x))
        out = F.gelu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.gelu(out + identity)


class WeatherMeshProcessor(nn.Module):
    """n_layers of 3D neighborhood attention on the latent volume."""

    def __init__(
        self,
        latent_dim: int,
        n_layers: int = 10,
        kernel: Sequence[int] = (5, 7, 7),
        num_heads: int = 8,
    ):
        super().__init__()
        self.layers = nn.ModuleList(
            NeighborhoodAttention3D(latent_dim, num_heads, tuple(kernel)) for _ in range(n_layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class WeatherMeshEncoder(nn.Module):
    """Surface (2D) + pressure (3D) conv paths -> latent -> attention layers.
    surface [B, H, W, C2], pressure [B, D, H, W, C3] -> latent
    [B, D + 1, H / 2^n, W / 2^n, latent_dim], all channels-last."""

    def __init__(
        self,
        input_channels_2d: int,
        input_channels_3d: int,
        latent_dim: int,
        n_pressure_levels: int,
        num_conv_blocks: int = 3,
        hidden_dim: int = 256,
        kernel_size: Sequence[int] = (5, 7, 7),
        num_heads: int = 8,
        num_transformer_layers: int = 3,
        norm: str = "group",
    ):
        super().__init__()
        widths = [hidden_dim * 2 ** (i + 1) for i in range(num_conv_blocks)]
        self.surface_path = nn.ModuleList(
            ConvDownBlock(c_in, c_out, norm=norm)
            for c_in, c_out in zip([input_channels_2d] + widths, widths)
        )
        self.pressure_path = nn.ModuleList(
            ConvDownBlock(c_in, c_out, is_3d=True, stride=(1, 2, 2), norm=norm)
            for c_in, c_out in zip([input_channels_3d] + widths, widths)
        )
        self.to_latent = _conv(3, widths[-1] if widths else input_channels_3d, latent_dim, 1)
        self.transformer_layers = nn.ModuleList(
            NeighborhoodAttention3D(latent_dim, num_heads, tuple(kernel_size))
            for _ in range(num_transformer_layers)
        )

    def forward(self, surface: torch.Tensor, pressure: torch.Tensor) -> torch.Tensor:
        surface = surface.permute(0, 3, 1, 2)
        pressure = pressure.permute(0, 4, 1, 2, 3)
        for surface_block, pressure_block in zip(self.surface_path, self.pressure_path):
            surface = surface_block(surface)
            pressure = pressure_block(pressure)
        # merge: pressure levels + surface as one extra depth slice
        features = torch.cat([pressure, surface[:, :, None]], dim=2)
        latent = self.to_latent(features).permute(0, 2, 3, 4, 1)
        for layer in self.transformer_layers:
            latent = layer(latent)
        return latent


class WeatherMeshDecoder(nn.Module):
    """Attention layers -> split -> mirrored upsampling paths; latent
    [B, D + 1, H', W', C] -> (surface [B, H, W, C2], pressure [B, D, H, W, C3])."""

    def __init__(
        self,
        latent_dim: int,
        output_channels_2d: int,
        output_channels_3d: int,
        n_conv_blocks: int = 3,
        hidden_dim: int = 256,
        kernel_size: Sequence[int] = (5, 7, 7),
        num_heads: int = 8,
        num_transformer_layers: int = 3,
        norm: str = "group",
    ):
        super().__init__()
        self.transformer_layers = nn.ModuleList(
            NeighborhoodAttention3D(latent_dim, num_heads, tuple(kernel_size))
            for _ in range(num_transformer_layers)
        )
        self.split = _conv(3, latent_dim, hidden_dim * 2**n_conv_blocks, 1)
        # path index j runs the JAX package's loop i = n - 1 .. 0
        order = list(reversed(range(n_conv_blocks)))
        self.pressure_path = nn.ModuleList(
            ConvUpBlock(hidden_dim * 2 ** (i + 1), hidden_dim * 2**i if i else output_channels_3d,
                        is_3d=True, norm=norm)
            for i in order
        )
        self.surface_path = nn.ModuleList(
            ConvUpBlock(hidden_dim * 2 ** (i + 1), hidden_dim * 2**i if i else output_channels_2d,
                        norm=norm)
            for i in order
        )

    def forward(self, latent: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        for layer in self.transformer_layers:
            latent = layer(latent)
        features = self.split(latent.permute(0, 4, 1, 2, 3))
        pressure, surface = features[:, :, :-1], features[:, :, -1]
        for pressure_block, surface_block in zip(self.pressure_path, self.surface_path):
            pressure = pressure_block(pressure)
            surface = surface_block(surface)
        return surface.permute(0, 2, 3, 1), pressure.permute(0, 2, 3, 4, 1)


@dataclass
class WeatherMeshOutput:
    surface: torch.Tensor  # [B, H, W, C2]
    pressure: torch.Tensor  # [B, D, H, W, C3]


class WeatherMeshModule(nn.Module):
    """End-to-end WeatherMesh as one nn.Module: forward(surface, pressure,
    forecast_steps) -> WeatherMeshOutput."""

    def __init__(
        self,
        timesteps: Sequence[int],
        surface_channels: int,
        pressure_channels: int,
        pressure_levels: int,
        latent_dim: int,
        encoder_num_conv_blocks: int = 3,
        encoder_num_transformer_layers: int = 3,
        encoder_hidden_dim: int = 256,
        decoder_num_conv_blocks: int = 3,
        decoder_num_transformer_layers: int = 3,
        decoder_hidden_dim: int = 256,
        processor_num_layers: int = 10,
        kernel: Sequence[int] = (5, 7, 7),
        num_heads: int = 8,
        norm: str = "group",
    ):
        super().__init__()
        kernel = tuple(kernel)
        self.encoder = WeatherMeshEncoder(
            surface_channels, pressure_channels, latent_dim, pressure_levels,
            encoder_num_conv_blocks, encoder_hidden_dim, kernel, num_heads,
            encoder_num_transformer_layers, norm,
        )
        self.processors = nn.ModuleList(
            WeatherMeshProcessor(latent_dim, processor_num_layers, kernel, num_heads)
            for _ in timesteps
        )
        self.decoder = WeatherMeshDecoder(
            latent_dim, surface_channels, pressure_channels, decoder_num_conv_blocks,
            decoder_hidden_dim, kernel, num_heads, decoder_num_transformer_layers, norm,
        )

    def forward(
        self, surface: torch.Tensor, pressure: torch.Tensor, forecast_steps: int = 1
    ) -> WeatherMeshOutput:
        latent = self.encoder(surface, pressure)
        for _ in range(forecast_steps):
            for processor in self.processors:
                latent = processor(latent)
        surface_out, pressure_out = self.decoder(latent)
        return WeatherMeshOutput(surface=surface_out, pressure=pressure_out)


class WeatherMesh:
    """WeatherMesh handle: owns the nn.Module (`.module`) and runs it on
    `device` ("cuda" unless the caller asks for "cpu").

    __call__(surface [B, H, W, C2], pressure [B, D, H, W, C3],
    forecast_steps=1) serves under torch.no_grad(); forward_fn() is the
    same function with autograd, for training. f32."""

    def __init__(
        self,
        timesteps: Sequence[int],
        surface_channels: int,
        pressure_channels: int,
        pressure_levels: int,
        latent_dim: int,
        encoder_num_conv_blocks: int = 3,
        encoder_num_transformer_layers: int = 3,
        encoder_hidden_dim: int = 256,
        decoder_num_conv_blocks: int = 3,
        decoder_num_transformer_layers: int = 3,
        decoder_hidden_dim: int = 256,
        processor_num_layers: int = 10,
        kernel: Sequence[int] = (5, 7, 7),
        num_heads: int = 8,
        norm: str = "group",
        device="cuda",
    ):
        self.surface_channels = surface_channels
        self.pressure_channels = pressure_channels
        self.pressure_levels = pressure_levels
        self.device = torch.device(device)
        self.module = WeatherMeshModule(
            timesteps, surface_channels, pressure_channels, pressure_levels, latent_dim,
            encoder_num_conv_blocks, encoder_num_transformer_layers, encoder_hidden_dim,
            decoder_num_conv_blocks, decoder_num_transformer_layers, decoder_hidden_dim,
            processor_num_layers, kernel, num_heads, norm,
        ).to(self.device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> dict:
        """Draw fresh weights from `generator` (a CPU generator: the same seed
        gives the same weights on any device) with the JAX package's
        initializers: conv kernels lecun-normal (flax's default: a normal
        truncated at 2 sigma, scaled to variance 1/fan_in) and conv biases 0;
        linear weights and biases uniform in +-1/sqrt(fan_in) (TorchLinear);
        norms scale 1 and bias 0; rpb 0. Returns the state_dict."""
        for sub in self.module.modules():
            if isinstance(sub, (nn.Conv2d, nn.Conv3d)):
                std = sub.weight[0].numel() ** -0.5 / 0.87962566103423978
                w = nn.init.trunc_normal_(torch.empty(sub.weight.shape), 0.0, 1.0, -2.0, 2.0,
                                          generator=generator)
                sub.weight.copy_(std * w)
                if sub.bias is not None:
                    sub.bias.zero_()
            elif isinstance(sub, nn.Linear):
                bound = sub.weight.shape[1] ** -0.5
                for t in (sub.weight, sub.bias):
                    t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=generator))
            elif isinstance(sub, (nn.GroupNorm, _RunningBatchNorm)):
                sub.reset_parameters()
            elif isinstance(sub, NeighborhoodAttention3D):
                sub.rpb.zero_()
        return self.module.state_dict()

    def _check_shapes(self, surface, pressure):
        b, h, w, c2 = surface.shape
        if tuple(pressure.shape) != (b, self.pressure_levels, h, w, self.pressure_channels) or (
            c2 != self.surface_channels
        ):
            raise ValueError(
                f"expected surface [B, H, W, {self.surface_channels}] and pressure "
                f"[B, {self.pressure_levels}, H, W, {self.pressure_channels}]; got "
                f"{tuple(surface.shape)} and {tuple(pressure.shape)}"
            )

    def _forward(self, surface, pressure, forecast_steps: int = 1) -> WeatherMeshOutput:
        surface, pressure = (
            torch.as_tensor(t, dtype=torch.float32, device=self.device) for t in (surface, pressure)
        )
        self._check_shapes(surface, pressure)
        return self.module(surface, pressure, forecast_steps)

    def forward_fn(self):
        """The training forward: a differentiable callable (surface,
        pressure, forecast_steps=1) -> WeatherMeshOutput, on self.device."""
        return self._forward

    @torch.no_grad()
    def apply(self, surface, pressure, forecast_steps: int = 1) -> WeatherMeshOutput:
        """Channels-last inputs (moved to self.device) -> WeatherMeshOutput."""
        return self._forward(surface, pressure, forecast_steps)

    __call__ = apply


@dataclass
class WeatherMeshProcessorConfig:
    latent_dim: int
    n_layers: int = 10
    kernel: tuple = (5, 7, 7)
    num_heads: int = 8

    @staticmethod
    def from_json(json: dict) -> "WeatherMeshProcessorConfig":
        return WeatherMeshProcessorConfig(**json)

    def to_json(self) -> dict:
        return asdict(self)

    def build(self) -> WeatherMeshProcessor:
        return WeatherMeshProcessor(self.latent_dim, self.n_layers, tuple(self.kernel), self.num_heads)


@dataclass
class WeatherMeshEncoderConfig:
    input_channels_2d: int
    input_channels_3d: int
    latent_dim: int
    n_pressure_levels: int
    num_conv_blocks: int = 3
    hidden_dim: int = 256
    kernel_size: tuple = (5, 7, 7)
    num_heads: int = 8
    num_transformer_layers: int = 3

    @staticmethod
    def from_json(json: dict) -> "WeatherMeshEncoderConfig":
        return WeatherMeshEncoderConfig(**json)

    def to_json(self) -> dict:
        return asdict(self)

    def build(self, norm: str = "group") -> WeatherMeshEncoder:
        return WeatherMeshEncoder(**{**asdict(self), "kernel_size": tuple(self.kernel_size)},
                                  norm=norm)


@dataclass
class WeatherMeshDecoderConfig:
    latent_dim: int
    output_channels_2d: int
    output_channels_3d: int
    n_conv_blocks: int = 3
    hidden_dim: int = 256
    kernel_size: tuple = (5, 7, 7)
    num_heads: int = 8
    num_transformer_layers: int = 3

    @staticmethod
    def from_json(json: dict) -> "WeatherMeshDecoderConfig":
        return WeatherMeshDecoderConfig(**json)

    def to_json(self) -> dict:
        return asdict(self)

    def build(self, norm: str = "group") -> WeatherMeshDecoder:
        return WeatherMeshDecoder(**{**asdict(self), "kernel_size": tuple(self.kernel_size)},
                                  norm=norm)


@dataclass
class WeatherMeshConfig:
    timesteps: List[int]
    surface_channels: int
    pressure_channels: int
    pressure_levels: int
    latent_dim: int
    encoder_num_conv_blocks: int = 3
    encoder_num_transformer_layers: int = 3
    encoder_hidden_dim: int = 256
    decoder_num_conv_blocks: int = 3
    decoder_num_transformer_layers: int = 3
    decoder_hidden_dim: int = 256
    processor_num_layers: int = 10
    kernel: tuple = (5, 7, 7)
    num_heads: int = 8
    norm: str = "group"

    @staticmethod
    def from_json(json: dict) -> "WeatherMeshConfig":
        return WeatherMeshConfig(**json)

    def to_json(self) -> dict:
        return asdict(self)

    def build(self, device="cuda") -> WeatherMesh:
        return WeatherMesh(
            **{**asdict(self), "timesteps": list(self.timesteps), "kernel": tuple(self.kernel)},
            device=device,
        )
