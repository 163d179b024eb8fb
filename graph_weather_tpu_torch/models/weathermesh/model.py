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

`forward_fn(compute_dtype=torch.bfloat16)` and `apply(...,
compute_dtype=torch.bfloat16)` run the module as `bench.py` runs the JAX one
(`_wm_bf16`: every floating parameter and both inputs in bf16): the modules
see bf16 weights (the convs f32 ones, which they round) and round where XLA
rounds the JAX module's bf16 run on the CPU: `_Bf16Conv`, `_linear`,
`_resize_bf16` here, the norms, GELU and bias gradients in nn/bf16.py, the
attention's bf16 kernels in ops/.

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

from graph_weather_tpu_torch.nn.bf16 import Bf16Params, bias_add, f32_sums, norm_gelu
from graph_weather_tpu_torch.ops.neighborhood_attention import neighborhood_attention_3d

# Where the compute policies the port does not run yet are queued.
POLICY_TODO = "ROADMAP.md, 'TF32 compute policy'"


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
    tensors cuDNN, as the plain module. On bf16 x the convolution is
    `_Bf16Conv`'s, rounded, and the bias added after it, rounded again
    (flax's Conv under the bf16 policy, nn.bf16.bias_add)."""

    def _conv_forward(self, input, weight, bias):
        if input.dtype == torch.bfloat16:
            out = _Bf16Conv.apply(input, weight, self.stride, self.padding, True)
            return out if bias is None else bias_add(out, bias, 1)
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


@contextlib.contextmanager
def _exact_convs(device: torch.device):
    """Around convolutions of bf16 values upcast to f32: on the CPU with
    oneDNN off (see the module docstring); on the card with cuDNN's TF32
    tensor cores on, which are exact here: a bf16 value's 8 significant
    bits fit TF32's 11, the products are exact and the sums f32, so the
    result is the f32 convolution's at tensor-core speed."""
    if device.type == "cpu":
        with _without_onednn():
            yield
        return
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class _Bf16Conv(torch.autograd.Function):
    """A bias-free convolution under the bf16 policy, as XLA computes it: of
    bf16 x and the f32 weight rounded to bf16, in f32 (`_exact_convs`); the
    result rounded to bf16 (`rounded`), or kept in f32 where its only use is
    a GroupNorm (whose centred term reads the f32 value and its statistics
    the rounded one: nn.bf16.norm_gelu). The gradient as convolutions of the
    bf16 cotangent in f32: dx rounded to bf16; dweight kept in f32, its only
    use being the f32 weight's (so the bf16 policy hands the convs their f32
    weights: `_conv_weights`)."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding, rounded):
        n = x.dim() - 2
        ctx.save_for_backward(x, weight)
        ctx.conf = (list(stride), list(padding), [1] * n, [0] * n)
        with _exact_convs(x.device):
            y = torch.ops.aten.convolution(x.float(), weight.to(torch.bfloat16).float(), None,
                                           *ctx.conf[:3], False, ctx.conf[3], 1)
        return y.to(torch.bfloat16) if rounded else y

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, zeros = ctx.conf
        with _exact_convs(x.device):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                grad.to(torch.bfloat16).float(), x.float(), weight.to(torch.bfloat16).float(), None,
                stride, padding, dilation, False, zeros, 1, [ctx.needs_input_grad[0], True, False],
            )
        return None if dx is None else dx.to(x.dtype), dw.to(weight.dtype), None, None, None


def _conv_normed(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """conv(x) whose only use is a norm: on bf16 x `_Bf16Conv`, f32 out."""
    if x.dtype != torch.bfloat16:
        return conv(x)
    return _Bf16Conv.apply(x, conv.weight, conv.stride, conv.padding, False)


def _norm_gelu(norm_a: nn.Module, xa: torch.Tensor, norm_b: nn.Module | None = None,
               xb: torch.Tensor | None = None) -> torch.Tensor:
    """gelu(norm_a(xa) (+ norm_b(xb))), exact GELU: GroupNorms through
    nn.bf16.norm_gelu (flax's GroupNorm and jax.nn.gelu under the bf16
    policy), BatchNorms as they are."""
    if isinstance(norm_a, nn.GroupNorm):
        return norm_gelu(norm_a, xa, norm_b, xb)
    return F.gelu(norm_a(xa) if norm_b is None else norm_a(xa) + norm_b(xb))


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """nn.Linear; on bf16 weights the product and the bias add each rounded,
    as XLA rounds TorchLinear's two operations (nn.bf16.bias_add)."""
    if layer.weight.dtype != torch.bfloat16:
        return layer(x)
    return bias_add(F.linear(x, layer.weight), layer.bias)


def _upsample_weights(n: int, scale: int, device) -> torch.Tensor:
    """[n * scale, n]: half-pixel-centred linear interpolation by `scale`
    along one axis (F.interpolate's weights, align_corners=False)."""
    eye = torch.eye(n, device=device)[None]  # [1, n (channels), n]
    return F.interpolate(eye, scale_factor=scale, mode="linear", align_corners=False)[0].T


def _resize_bf16(x: torch.Tensor, scales) -> torch.Tensor:
    """The x2 resize of H and W (the last two axes) of x [B, C, (D,) H, W]
    under the bf16 policy, as jax.image.resize computes it: one einsum of x
    and two bf16 weight matrices, which contracts one axis at a time (each
    result rounded to bf16) in the order of least cost, W first where W > H,
    else H first (as the JAX package's einsum chooses a tie)."""
    h_axis, w_axis = x.dim() - 2, x.dim() - 1
    order = (w_axis, h_axis) if x.shape[w_axis] > x.shape[h_axis] else (h_axis, w_axis)
    for axis in order:
        w = _upsample_weights(x.shape[axis], scales[axis - 2], x.device).to(x.dtype)
        x = torch.movedim(torch.movedim(x, axis, -1) @ w.T, -1, axis)
    return x


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
            t.reshape(b, d, h, w, heads, c // heads) for t in _linear(self.qkv, x).chunk(3, dim=-1)
        )
        out = neighborhood_attention_3d(q, k, v, self.kernel_size, self.rpb, self.circular_w)
        return _linear(self.proj, out.reshape(b, d, h, w, c))


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
        identity = _conv_normed(self.downsample, x)
        out = _norm_gelu(self.bn1, _conv_normed(self.conv1, x))
        return _norm_gelu(self.bn2, _conv_normed(self.conv2, out), self.bn_down, identity)


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
        if x.dtype == torch.bfloat16:
            x = _resize_bf16(x, self.scale)
        else:
            x = F.interpolate(x, scale_factor=self.scale, mode=self.mode, align_corners=False)
        identity = _conv_normed(self.upsample, x)
        out = _norm_gelu(self.bn1, _conv_normed(self.conv1, x))
        return _norm_gelu(self.bn2, _conv_normed(self.conv2, out), self.bn_up, identity)


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


def _conv_weights(module: nn.Module) -> set[str]:
    """The names of the convs' weights, which the bf16 policy leaves f32
    (`_Bf16Conv` rounds them, and keeps their gradients in f32)."""
    return {f"{name}.weight" for name, sub in module.named_modules()
            if isinstance(sub, (nn.Conv2d, nn.Conv3d))}


class WeatherMesh:
    """WeatherMesh handle: owns the nn.Module (`.module`) and runs it on
    `device` ("cuda" unless the caller asks for "cpu").

    __call__(surface [B, H, W, C2], pressure [B, D, H, W, C3],
    forecast_steps=1) serves under torch.no_grad(); forward_fn() is the
    same function with autograd, for training. Both run in f32, or with
    compute_dtype=torch.bfloat16 in bf16 (the JAX package's bench.py policy:
    see forward_fn)."""

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
        self.norm = norm
        self._bf16 = None  # Bf16Params of the module, made at the first bf16 forward
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
        """The module in its parameters' dtype, as the JAX module runs in its
        variables' (the inputs are cast to it)."""
        dtype = next(self.module.parameters()).dtype
        surface, pressure = (
            torch.as_tensor(t, device=self.device).to(dtype) for t in (surface, pressure)
        )
        self._check_shapes(surface, pressure)
        return self.module(surface, pressure, forecast_steps)

    def _forward16(self, surface, pressure, forecast_steps: int = 1) -> WeatherMeshOutput:
        if self._bf16 is None:
            self._bf16 = Bf16Params(self.module, keep_f32=_conv_weights(self.module))
        surface, pressure = (
            torch.as_tensor(t, device=self.device).to(torch.bfloat16) for t in (surface, pressure)
        )
        self._check_shapes(surface, pressure)
        with f32_sums():  # the products sum in f32, as XLA's
            return torch.func.functional_call(
                self.module, self._bf16(), (surface, pressure, forecast_steps)
            )

    def forward_fn(self, compute_dtype=None):
        """The training forward: a differentiable callable (surface,
        pressure, forecast_steps=1) -> WeatherMeshOutput, on self.device.

        compute_dtype=torch.bfloat16 is what bench.py's `_wm_bf16` does to
        the JAX model: every floating parameter cast to bf16 (one flat cast,
        nn.bf16.Bf16Params: kept while the parameters are unchanged when
        serving, in the autograd graph when training, so the f32 parameters
        get f32 gradients), both inputs cast to bf16, bf16 outputs. The
        modules round where XLA rounds the JAX module's bf16 run (nn.bf16:
        GroupNorm in f32 rounded once, GELU one operation at a time; each
        linear's and conv's product and bias add; the resize one axis at a
        time), and the attention runs the bf16 modes of its kernels. None
        or torch.float32 run in f32; other dtypes, and bf16 with norm
        "batch", raise."""
        if compute_dtype in (None, torch.float32):
            return self._forward
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError(
                f"compute_dtype={compute_dtype}: WeatherMesh runs float32 and bfloat16. "
                f"See {POLICY_TODO}."
            )
        if self.norm != "group":
            raise NotImplementedError(
                f"compute_dtype=bfloat16 with norm={self.norm!r}: only GroupNorm has a bf16 "
                f"policy. See {POLICY_TODO}."
            )
        return self._forward16

    @torch.no_grad()
    def apply(self, surface, pressure, forecast_steps: int = 1, compute_dtype=None) -> WeatherMeshOutput:
        """Channels-last inputs (moved to self.device) -> WeatherMeshOutput,
        in f32 or in compute_dtype (see forward_fn)."""
        return self.forward_fn(compute_dtype)(surface, pressure, forecast_steps)

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
