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
  * `norm_gelu`: jax.nn.gelu(approximate=False) of flax's GroupNorm (or of
    the sum of two), as WeatherMesh's conv blocks run them: the norms in f32
    rounded once, the GELU one rounded operation at a time (but the product
    that enters erfc), and the gradient as JAX differentiates them;
  * `bias_add`: y + bias, whose bias gradient XLA:CPU sums in bf16 row
    after row, each partial sum rounded, in windows of up to 32 rows an
    axis (`xla_sum_order`);
  * `Bf16Params`: bf16 copies of a module's parameters through one cast;
  * `f32_sums`: cuBLAS's bf16 products summed in f32 and rounded once, as
    XLA's dot.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from graph_weather_tpu_torch.ops.scatter import segment_sum_bf16

XLA_SUM_WINDOW = 32  # XLA:CPU's tree reduction window


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


def _stats_backward(xs, centred, r, scale, g, var, axes, n):
    """The gradient of a normalization's input through flax's program (the
    fast variance max(0, mean(x^2) - mean(x)^2), y = (x - mean) r scale +
    bias), rounded as XLA rounds it on a bf16 input: the gradients through
    the centred and the statistics' f32 upcasts each rounded to bf16, then
    added in bf16. xs is what the statistics read, `axes` the reduced axes
    (n elements), `scale` the affine scale broadcast to x (1.0 without)."""
    d_centred = g * (r * scale)
    d_r = (g * centred * scale).sum(axes, keepdim=True)
    d_var = torch.where(var > 0, -0.5 * d_r * r**3, torch.zeros_like(d_r))
    d_mean = -d_centred.sum(axes, keepdim=True) - 2.0 * (xs.sum(axes, keepdim=True) / n) * d_var
    d_stats = (2.0 * xs * d_var + d_mean) / n
    return d_centred.to(torch.bfloat16) + d_stats.to(torch.bfloat16)


def _group_stats(x32, eps):
    """(mean, var, rsqrt(var + eps)) per group of x32 [B, G, Cg, S] as flax
    takes them (var = max(0, mean(x^2) - mean(x)^2)), of x rounded to bf16:
    where x is the f32 result of a conv (`_Bf16Conv` of
    models/weathermesh), XLA's statistics read its bf16 rounding and only
    the centred term the f32 value."""
    xs = x32.to(torch.bfloat16).float()
    mean = xs.mean((2, 3), keepdim=True)
    var = torch.clamp((xs * xs).mean((2, 3), keepdim=True) - mean * mean, min=0.0)
    return mean, var, torch.rsqrt(var + eps)


def _gn_forward(x, weight, bias, groups, eps):
    """flax's GroupNorm of x [B, C, *S] in f32 (`_group_stats`), unrounded."""
    b, c = x.shape[:2]
    x32 = x.float().reshape(b, groups, c // groups, -1)
    mean, _, r = _group_stats(x32, eps)
    w32 = weight.float().view(1, groups, c // groups, 1)
    y = (x32 - mean) * (r * w32) + bias.float().view(1, groups, c // groups, 1)
    return y.reshape(x.shape)


def _gn_backward(x, weight, groups, eps, grad):
    """(dx, dweight, dbias) of `_gn_forward` for the cotangent grad (f32 or
    bf16): dx `_stats_backward` (bf16 values, in x's dtype), dweight and
    dbias f32 sums in the parameters' dtype."""
    b, c = x.shape[:2]
    x32 = x.float().reshape(b, groups, c // groups, -1)
    g = grad.float().reshape(x32.shape)
    mean, var, r = _group_stats(x32, eps)
    centred = x32 - mean
    w32 = weight.float().view(1, groups, c // groups, 1)
    dx = _stats_backward(x32.to(torch.bfloat16).float(), centred, r, w32, g, var, (2, 3),
                         x32.shape[2] * x32.shape[3])
    d_weight = (g * centred * r).sum((0, 3)).reshape(c).to(weight.dtype)
    return dx.reshape(x.shape).to(x.dtype), d_weight, g.sum((0, 3)).reshape(c).to(weight.dtype)


_SQRT_HALF = float(torch.tensor(0.5**0.5).to(torch.bfloat16))  # the JAX package's bf16 constants
_ERFC_SLOPE = float(torch.tensor(-2.0 / torch.pi**0.5).to(torch.bfloat16))


def _gelu_forward(x):
    """jax.nn.gelu(x, approximate=False) on bf16 x as XLA runs it: (0.5 x)
    erfc((-x) sqrt(1/2)) with the constant rounded to bf16; the product
    (-x) sqrt(1/2) enters erfc (computed in f32) unrounded, its only use
    there being erfc's f32 upcast; erfc's value and the last product
    rounded. Returns (gelu, erfc's value)."""
    e = torch.special.erfc(-x.float() * _SQRT_HALF).to(torch.bfloat16)
    return (0.5 * x) * e, e


def _gelu_backward(x, e, grad):
    """The gradient of `_gelu_forward` as JAX differentiates it, each
    operation rounded to bf16 (erfc's derivative -2/sqrt(pi) exp(-t^2) on
    the rounded t, its linear part transposed: the constant first) but the
    last add, returned in f32 unrounded: it feeds only the f32 upcasts of a
    GroupNorm's backward."""
    t = -x * _SQRT_HALF  # rounded: its other use, t * t, is a bf16 product
    ct_a, ct_b = grad * e, grad * (0.5 * x)
    ct_t = (_ERFC_SLOPE * ct_b) * torch.exp(-(t * t))
    return (0.5 * ct_a).float() - (ct_t * _SQRT_HALF).float()


class Bf16NormGelu(torch.autograd.Function):
    """gelu(GroupNorm(xa) (+ GroupNorm(xb))) under the bf16 policy, as one
    function so that the gradient between the GELU and the norms stays f32:
    XLA computes the GELU backward's last add in f32 and feeds it to the
    norms' backward unrounded. Each norm's result rounded to bf16 (and their
    sum, where there are two), the GELU `_gelu_forward`."""

    @staticmethod
    def forward(ctx, groups, eps, xa, wa, ba, xb=None, wb=None, bb=None):
        s = _gn_forward(xa, wa, ba, groups[0], eps[0]).to(torch.bfloat16)
        if xb is not None:
            s = s + _gn_forward(xb, wb, bb, groups[1], eps[1]).to(torch.bfloat16)
        out, e = _gelu_forward(s)
        ctx.save_for_backward(xa, wa, xb, wb, s, e)
        ctx.groups, ctx.eps = groups, eps
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        xa, wa, xb, wb, s, e = ctx.saved_tensors
        ct = _gelu_backward(s, e, grad)
        grads = _gn_backward(xa, wa, ctx.groups[0], ctx.eps[0], ct)
        if xb is not None:
            grads += _gn_backward(xb, wb, ctx.groups[1], ctx.eps[1], ct)
        else:
            grads += (None, None, None)
        return (None, None, *grads)


def norm_gelu(norm_a: nn.GroupNorm, xa: torch.Tensor, norm_b: nn.GroupNorm | None = None,
              xb: torch.Tensor | None = None) -> torch.Tensor:
    """gelu(norm_a(xa) (+ norm_b(xb))) on bf16 GroupNorm weights under the
    bf16 policy (Bf16NormGelu); otherwise torch's GroupNorm and exact GELU."""
    if norm_a.weight.dtype != torch.bfloat16:
        s = F.group_norm(xa, norm_a.num_groups, norm_a.weight, norm_a.bias, norm_a.eps)
        if norm_b is not None:
            s = s + F.group_norm(xb, norm_b.num_groups, norm_b.weight, norm_b.bias, norm_b.eps)
        return F.gelu(s)
    if norm_b is None:
        return Bf16NormGelu.apply((norm_a.num_groups,), (norm_a.eps,), xa, norm_a.weight,
                                  norm_a.bias)
    return Bf16NormGelu.apply((norm_a.num_groups, norm_b.num_groups), (norm_a.eps, norm_b.eps),
                              xa, norm_a.weight, norm_a.bias, xb, norm_b.weight, norm_b.bias)


def _tree_windows(n: int) -> tuple[np.ndarray, int]:
    """XLA:CPU's windows over one reduced axis of n rows, (the window of
    each row, the number of windows): the whole axis up to 32 rows; beyond,
    windows of 32 over the axis padded to a multiple of 32, with half the
    padding (rounded down) in front and the rest behind."""
    if n <= XLA_SUM_WINDOW:
        return np.zeros(n, np.int64), 1
    count = -(-n // XLA_SUM_WINDOW)
    front = (count * XLA_SUM_WINDOW - n) // 2
    return (np.arange(n) + front) // XLA_SUM_WINDOW, count


def xla_sum_order(dims: tuple[int, ...]) -> list[tuple[np.ndarray, np.ndarray]]:
    """The order of XLA:CPU's bf16 sum over the leading axes `dims` of
    row-major rows [prod(dims), C], as levels of flat CSR (offsets, ids):
    each level sums each window's rows in row-major order, one rounded add
    at a time, and the next level sums the windows' results (row-major
    over the windows) the same way, until one is left. Up to 32 rows an
    axis, that is one serial sum of every row; a longer axis is cut into
    windows (`_tree_windows`), as XLA's tree reduction rewriter cuts it."""
    levels = []
    while True:
        windows = [_tree_windows(n) for n in dims]
        counts = tuple(count for _, count in windows)
        grid = np.meshgrid(*(w for w, _ in windows), indexing="ij")
        window = np.ravel_multi_index([g.ravel() for g in grid], counts)
        ids = np.argsort(window, kind="stable")
        offsets = np.concatenate([[0], np.cumsum(np.bincount(window, minlength=int(np.prod(counts))))])
        levels.append((offsets.astype(np.int32), ids.astype(np.int32)))
        if all(count == 1 for count in counts):
            return levels
        dims = counts


@functools.lru_cache(maxsize=64)
def _sum_tables(dims: tuple[int, ...], device: torch.device) -> tuple:
    return tuple((torch.from_numpy(offsets).to(device), torch.from_numpy(ids).to(device))
                 for offsets, ids in xla_sum_order(dims))


class _Bf16BiasAdd(torch.autograd.Function):
    """y + bias (bias broadcast along `axis`), rounded; the bias gradient
    the sum of the cotangent's rows [B * .., C] in XLA:CPU's order, each
    partial sum rounded to bf16 (`xla_sum_order`): one ordered segment sum
    S (ops/scatter.py) a level."""

    @staticmethod
    def forward(ctx, y, bias, axis):
        ctx.axis = axis
        shape = [1] * y.dim()
        shape[axis] = -1
        return y + bias.view(shape)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        rows = grad.movedim(ctx.axis, -1)
        dims = tuple(rows.shape[:-1])
        rows = rows.reshape(-1, rows.shape[-1])
        for offsets, ids in _sum_tables(dims, rows.device):
            rows = segment_sum_bf16(rows, offsets, ids)
        return grad, rows[0], None


def bias_add(y: torch.Tensor, bias: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """bf16 y + bias along `axis`, with XLA:CPU's bf16 bias gradient
    (_Bf16BiasAdd)."""
    return _Bf16BiasAdd.apply(y, bias, axis % y.dim())


class Bf16Params:
    """bf16 copies of `module`'s parameters, {name: tensor}, for
    torch.func.functional_call: one torch.cat of the flattened parameters
    and one cast, then views, where a cast per tensor would launch a kernel
    for each. Each parameter's segment starts 16-byte aligned.

    Under autograd the cast stays in the graph, so the f32 parameters get
    f32 gradients (the bf16 gradients upcast). Without it (serving,
    rollouts) the copy is kept and reused while no parameter has been
    written (each one's version counter and storage unchanged). The
    parameters named in `keep_f32` are handed over as they are, f32 (for
    modules that round them themselves)."""

    ALIGN = 8  # bf16 elements in 16 bytes

    def __init__(self, module: nn.Module, keep_f32=()):
        named = [(n, p) for n, p in module.named_parameters() if n not in keep_f32]
        self.names, self.params = zip(*named)
        self.kept = {n: p for n, p in module.named_parameters() if n in keep_f32}
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
            **self.kept,
            **{name: flat[o : o + p.numel()].view(p.shape)
               for name, p, o in zip(self.names, self.params, offsets)},
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
