"""The bf16 compute policy's shared pieces: elementwise operations rounded
as the JAX package's bf16 run rounds them, and one flat cast of a module's
parameters.

Under the JAX package's bf16 policy (the forecaster's and GenCast's
forward_fn(compute_dtype=bfloat16)) the parameters are cast to bf16 at
entry and XLA rounds every bf16 operation's result to bf16, with one
exception: an elementwise operation (or dot) whose only use is an upcast to
f32 is computed in f32 and not rounded. The modules of the port know the
policy is on by their parameters' dtype and call these:

  * `silu`, `sigmoid`: x * (1 / (1 + exp(-x))), one rounded operation at a
    time, and their gradients as JAX differentiates them;
  * `layer_norm`: flax's LayerNorm, whose statistics and affine are f32 and
    whose result is rounded once; on f32 weights torch's own;
  * `Bf16Params`: bf16 copies of a module's parameters through one cast;
  * `f32_sums`: cuBLAS's bf16 products summed in f32 and rounded once, as
    XLA's dot.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn


class Bf16Sigmoid(torch.autograd.Function):
    """jax.nn.sigmoid on bf16 as XLA runs it: l = 1 / (1 + exp(-x)), each
    operation rounded to bf16; the gradient ct * (l * (1 - l)), rounded as
    JAX's (the derivative is a bf16 product of bf16 values)."""

    @staticmethod
    def forward(ctx, x):
        sig = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(sig)
        return sig

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (sig,) = ctx.saved_tensors
        return grad * (sig * (1.0 - sig))


class Bf16Silu(torch.autograd.Function):
    """flax's nn.silu on bf16, x * sigmoid(x), as XLA runs it (see
    Bf16Sigmoid); the gradient ct * l + (x * ct) * (l * (1 - l)), each
    operation rounded to bf16, as JAX differentiates it."""

    @staticmethod
    def forward(ctx, x):
        sig = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(x, sig)
        return x * sig

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, sig = ctx.saved_tensors
        return grad * sig + (x * grad) * (sig * (1.0 - sig))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid: with its bf16 rounding on bf16 (Bf16Sigmoid)."""
    return Bf16Sigmoid.apply(x) if x.dtype == torch.bfloat16 else torch.sigmoid(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """flax's nn.silu: with its bf16 rounding on bf16 (Bf16Silu)."""
    return Bf16Silu.apply(x) if x.dtype == torch.bfloat16 else F.silu(x)


def layer_norm_backward(x, weight, grad, eps):
    """The gradients of flax's LayerNorm under the bf16 policy, as XLA
    differentiates flax's program (the fast variance max(0, mean(x^2) -
    mean(x)^2)): (dx, dweight, dbias). x's two f32 upcasts (one for the
    statistics, one centred) each get their gradient rounded to bf16, and
    the two are added in bf16; dx has x's dtype (bf16, or f32 for the f32
    of a `wide` linear, whose values it then holds). dweight and dbias are
    f32 sums over the rows (None without weight)."""
    x32, g = x.float(), grad.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
    r = torch.rsqrt(var + eps)
    centred = x32 - mean
    scale = 1.0 if weight is None else weight.float()
    d_centred = g * (r * scale)  # through the centred upcast
    d_r = (g * centred * scale).sum(-1, keepdim=True)
    d_var = torch.where(var > 0, -0.5 * d_r * r**3, torch.zeros_like(d_r))
    d_mean = -d_centred.sum(-1, keepdim=True) - 2.0 * mean * d_var
    d_stats = (2.0 * x32 * d_var + d_mean) / x32.shape[-1]  # through the statistics' upcast
    dx = (d_centred.to(torch.bfloat16) + d_stats.to(torch.bfloat16)).to(x.dtype)
    if weight is None:
        return dx, None, None
    lead = tuple(range(g.dim() - 1))
    return dx, (g * centred * r).sum(lead), g.sum(lead)


class Bf16LayerNorm(torch.autograd.Function):
    """flax's LayerNorm (eps 1e-5) as the JAX package runs it under the bf16
    policy, forward and backward. Forward: statistics, the optional scale
    and bias in f32, the result rounded to bf16. Backward:
    layer_norm_backward. x is bf16, or the f32 of a `wide` linear or gate."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        affine = [None if t is None else t.float() for t in (weight, bias)]
        return F.layer_norm(x.float(), x.shape[-1:], *affine, eps).to(torch.bfloat16)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        dx, d_weight, d_bias = layer_norm_backward(x, weight, grad, ctx.eps)
        if weight is None:
            return dx, None, None, None
        return dx, d_weight.to(weight.dtype), d_bias.to(weight.dtype), None


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax's LayerNorm under the bf16 policy (bf16 weights: Bf16LayerNorm,
    on x bf16 or the f32 of a `wide` linear); otherwise torch's LayerNorm
    of `norm`."""
    if norm.weight.dtype != torch.bfloat16:
        return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return Bf16LayerNorm.apply(x, norm.weight, norm.bias, norm.eps)


class Bf16Params:
    """bf16 copies of `module`'s parameters, {name: tensor}, for
    torch.func.functional_call: one torch.cat of the flattened parameters
    and one cast, then views, where a cast per tensor would launch a kernel
    for each. Each parameter's segment starts 16-byte aligned.

    Under autograd the cast stays in the graph, so the f32 parameters get
    f32 gradients (the bf16 gradients upcast). Without it (serving,
    rollouts) the copy is kept and reused while no parameter has been
    written (each one's version counter and storage unchanged)."""

    ALIGN = 8  # bf16 elements in 16 bytes

    def __init__(self, module: nn.Module):
        self.names, self.params = zip(*module.named_parameters())
        self._key = self._copy = None

    def __call__(self) -> dict:
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.params):
            return self._cast()
        key = tuple((p.data_ptr(), p._version) for p in self.params)
        if key != self._key:
            self._key, self._copy = None, None  # free the old copy first
            self._copy, self._key = self._cast(), key
        return self._copy

    def _cast(self) -> dict:
        first = self.params[0]
        pad = torch.zeros(self.ALIGN, dtype=first.dtype, device=first.device)
        parts, offsets, offset = [], [], 0
        for p in self.params:
            parts.append(p.reshape(-1))
            offsets.append(offset)
            offset += p.numel()
            tail = -p.numel() % self.ALIGN
            if tail:
                parts.append(pad[:tail])
                offset += tail
        flat = torch.cat(parts).to(torch.bfloat16)
        return {
            name: flat[o : o + p.numel()].view(p.shape)
            for name, p, o in zip(self.names, self.params, offsets)
        }


@contextlib.contextmanager
def f32_sums():
    """Within it, cuBLAS's bf16 products sum in f32 and round once, as XLA's
    dot does: no reduced-precision partial sums
    (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction off,
    restored after)."""
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
