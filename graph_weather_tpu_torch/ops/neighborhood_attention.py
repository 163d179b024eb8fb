"""3D neighborhood attention (NATTEN), port of
graph_weather_tpu/ops/neighborhood_attention.py.

Layout [B, D, H, W, heads, ch]. Every query attends to exactly
kd * kh * kw keys: on each axis its window starts at
clip(i - k//2, 0, size - k) (near an edge the window slides inward), or,
on a circular W axis, at i - k//2 modulo W. q is scaled by ch^-0.5, and a
learned relative-position bias rpb [heads, 2kd-1, 2kh-1, 2kw-1], indexed by
key - query + k - 1 on each axis (a circular axis: by the window slot,
slot - k//2 + k - 1), is added to every logit.

`neighborhood_attention_3d(..., impl=)` is the JAX package's dispatcher.
CPU tensors take the plain PyTorch version
(`neighborhood_attention_3d_reference`) under every impl, and its explicit
backward (ops/natten_flash.py) under autograd. For CUDA tensors `route`
picks the kernel from the shape alone, before any launch (bf16 tensors too:
each kernel has a bf16 mode that rounds as the JAX package's bf16 run of the
same path does, and on the CPU the plain version of what `route` names):

  * "auto": the halo-tiled K5a (ops/natten_flash.py; K5a and K5b under a
    gradient) when its tiles fit, else the wide-head K6 (ops/natten3d.py;
    K6 with lse and its backward K6b under a gradient);
  * "flash": K5a/K5b, or ValueError; "pallas": K6/K6b, or ValueError;
  * "xla": the plain version, because the caller named it (autograd
    differentiates it); no other impl reaches it on the card.

A failed build or launch always propagates.
"""

from __future__ import annotations

import numpy as np
import torch

_NEG = -1e30  # running-max start of the online softmax


def _window_indices(size: int, kernel: int, circular: bool) -> tuple[np.ndarray, np.ndarray]:
    """([size, kernel] gather indices, [size, kernel] relative-offset ids).

    Clamped: window start = clip(i - kernel//2, 0, size - kernel).
    Circular: window wraps (indices mod size); requires kernel <= size.
    Relative ids are (index - i) + kernel - 1 in [0, 2 kernel - 2].
    """
    if kernel > size:
        raise ValueError(f"kernel ({kernel}) must be <= axis size ({size})")
    i = np.arange(size)[:, None]
    k = np.arange(kernel)[None, :]
    if circular:
        idx = (i - kernel // 2 + k) % size
        rel = k - kernel // 2 + kernel - 1  # constant per slot
        rel = np.broadcast_to(rel, (size, kernel)).copy()
    else:
        start = np.clip(i - kernel // 2, 0, size - kernel)
        idx = start + k
        rel = idx - i + kernel - 1
    return idx.astype(np.int32), rel.astype(np.int32)


def _slot_tables(shape, kernel, circular_w, device):
    """Per axis, [size, k] gather indices and relative ids as long tensors."""
    _, d, h, w = shape[:4]
    tables = []
    for size, kk, circ in zip((d, h, w), kernel, (False, False, circular_w)):
        idx, rel = _window_indices(size, kk, circ)
        tables.append(
            (torch.as_tensor(idx, dtype=torch.long, device=device),
             torch.as_tensor(rel, dtype=torch.long, device=device))
        )
    return tables


def _slots(kernel):
    kd, kh, kw = kernel
    return [(x, y, z) for x in range(kd) for y in range(kh) for z in range(kw)]


def _gather(t, tables, slot):
    """t [B, D, H, W, ...] at every query's key of window slot (x, y, z)."""
    for axis, ((idx, _), s) in enumerate(zip(tables, slot), start=1):
        t = t.index_select(axis, idx[:, s])
    return t


def _slot_bias(rpb, tables, slot):
    """rpb at every query's slot (x, y, z): [D, H, W, heads]."""
    (_, rd), (_, rh), (_, rw) = tables
    x, y, z = slot
    bias = rpb[:, rd[:, x]][:, :, rh[:, y]][:, :, :, rw[:, z]]  # [heads, D, H, W]
    return bias.permute(1, 2, 3, 0)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16, as f32."""
    return t.to(torch.bfloat16).float()


def ordered_scatter_bf16(src: torch.Tensor, axis: int, idx: torch.Tensor, size: int) -> torch.Tensor:
    """The transpose of a take of `idx` [n] along `axis` (into an axis of
    `size`) on bf16 values, as XLA runs it: each target adds the sources
    that reach it in ascending order, rounding every sum to bf16. src holds
    bf16 values as f32; so does the result. On a clamped window table a
    target has more than one source only at the edges (at most k / 2 + 1)."""
    sources: dict[int, list[int]] = {}
    for i, t in enumerate(idx.tolist()):
        sources.setdefault(t, []).append(i)
    shape = list(src.shape)
    shape[axis] = size
    out = torch.zeros(shape, device=src.device).index_add_(axis, idx, src)  # exact: one source
    for t, run in sources.items():
        if len(run) > 1:
            acc = src.select(axis, run[0])
            for i in run[1:]:
                acc = round_bf16(acc + src.select(axis, i))
            out.select(axis, t).copy_(acc)
    return out


def bf16_scale(ch: int) -> float:
    """ch^-0.5 as the JAX package's bf16 run scales q: `q * scale` with q bf16
    takes the Python float as bf16 (a weak type), so the scale is rounded
    to bf16 first."""
    return float(torch.tensor(ch**-0.5).to(torch.bfloat16))


def scaled_q(q: torch.Tensor, rounded: bool = False) -> torch.Tensor:
    """q-hat, the scaled q that every kernel and plain version multiplies k
    with, in f32: on f32 q, q * ch^-0.5; on bf16 q, q * bf16_scale(ch) in
    f32, and with `rounded` that product rounded to bf16. The JAX package's
    Pallas kernels take bf16(q * scale) (K5a, K5b: `rounded`); its XLA slot
    scan upcasts q * scale to f32 right away, which XLA computes in f32
    unrounded (the slot path, K6 and K6b)."""
    ch = q.shape[-1]
    if q.dtype != torch.bfloat16:
        return (q * ch**-0.5).float()
    qs = q.float() * bf16_scale(ch)
    return round_bf16(qs) if rounded else qs


def slot_forward(q, k, v, kernel, rpb=None, circular_w=False):
    """The slot scan: (out, lse, out32). out32 is the f32 result acc / l
    before out's rounding to q's dtype (out itself in f32): the JAX package
    differentiates the scan through that f32 value, so the bf16 backward
    takes delta = dO . out32 (ops/natten3d.py)."""
    tables = _slot_tables(q.shape, kernel, circular_w, q.device)
    qs = scaled_q(q)
    m = torch.full(q.shape[:-1], _NEG, device=q.device)
    l = torch.zeros(q.shape[:-1], device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for slot in _slots(kernel):
        logits = (qs * _gather(k, tables, slot).float()).sum(-1)
        if rpb is not None:
            logits = logits + _slot_bias(rpb, tables, slot).float()
        m_new = torch.maximum(m, logits)
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l = l * alpha + p
        acc = acc * alpha[..., None] + p[..., None] * _gather(v, tables, slot).float()
        m = m_new
    out32 = acc / l[..., None]
    return out32.to(q.dtype), m + torch.log(l), out32


def neighborhood_attention_3d_reference(
    q: torch.Tensor,  # [B, D, H, W, heads, ch]
    k: torch.Tensor,
    v: torch.Tensor,
    kernel: tuple[int, int, int],
    rpb: torch.Tensor | None = None,  # [heads, 2kd-1, 2kh-1, 2kw-1]
    circular_w: bool = False,
    with_lse: bool = False,
):
    """Plain PyTorch version (the JAX package's slot scan): a loop over the
    window slots, per-axis gathers, an online softmax in f32. Differentiable
    by autograd. Returns out, or (out, lse) with the log-sum-exp of each
    (node, head) [B, D, H, W, heads] of the biased, scaled logits. On bf16
    tensors the scan's bf16 forward as XLA computes it: q-hat (`scaled_q`,
    unrounded), f32 logits, bias and softmax, out rounded to bf16 once."""
    out, lse, _ = slot_forward(q, k, v, kernel, rpb, circular_w)
    return (out, lse) if with_lse else out


def _check(q, k, v, kernel, rpb, circular_w):
    if q.dim() != 6 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("neighborhood_attention_3d: q, k, v [B, D, H, W, heads, ch], one shape")
    if len(kernel) != 3:
        raise ValueError(f"neighborhood_attention_3d: kernel {kernel} must have 3 sizes")
    for size, kk, circ in zip(q.shape[1:4], kernel, (False, False, circular_w)):
        _window_indices(size, kk, circ)  # raises when the kernel exceeds the axis
    heads = q.shape[-2]
    if rpb is not None and tuple(rpb.shape) != (heads, *(2 * kk - 1 for kk in kernel)):
        raise ValueError(f"neighborhood_attention_3d: rpb {tuple(rpb.shape)} must be "
                         f"[heads, 2kd-1, 2kh-1, 2kw-1] for heads {heads}, kernel {kernel}")
    tensors = (q, k, v) if rpb is None else (q, k, v, rpb)
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError("neighborhood_attention_3d: q, k, v and rpb must share one dtype, "
                        "float32 or bfloat16")
    if any(t.device != q.device for t in tensors):
        raise ValueError("neighborhood_attention_3d: all tensors must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"neighborhood_attention_3d: no kernel for device {q.device}")


IMPLS = ("auto", "flash", "pallas", "xla")
DTYPES = (torch.float32, torch.bfloat16)


def route(shape, kernel, circular_w: bool, has_bias: bool, needs_grad: bool,
          impl: str = "auto") -> str:
    """What `neighborhood_attention_3d(..., impl=impl)` runs for CUDA tensors
    of `shape` [B, D, H, W, heads, ch]: "flash" (K5a, with K5b under a
    gradient), "slot" (K6, with K6b under a gradient) or "plain"
    (impl="xla"). A pure host function: ValueError for an unknown impl or a
    shape the named kernel does not take."""
    from graph_weather_tpu_torch.ops import natten3d, natten_flash

    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "xla":
        return "plain"
    if impl in ("auto", "flash"):
        try:
            natten_flash.takes(shape, kernel, circular_w, has_bias, backward=needs_grad)
            return "flash"
        except ValueError:
            if impl == "flash":
                raise
    natten3d.takes(shape, kernel, circular_w, has_bias, backward=needs_grad)
    return "slot"


def neighborhood_attention_3d(
    q: torch.Tensor,  # [B, D, H, W, heads, ch]
    k: torch.Tensor,
    v: torch.Tensor,
    kernel: tuple[int, int, int],
    rpb: torch.Tensor | None = None,  # [heads, 2kd-1, 2kh-1, 2kw-1]
    circular_w: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Returns [B, D, H, W, heads, ch]; differentiable in q, k, v and rpb.
    impl: "auto", "flash", "pallas" or "xla"
    (see the module docstring; ValueError for any other). CPU tensors take
    the plain version (its explicit backward under autograd) under every
    impl (on bf16 tensors the plain version of what `route` names for the
    card: `_cpu_path`); CUDA tensors run what `route` picks, or raise."""
    from graph_weather_tpu_torch.ops import natten3d, natten_flash
    from graph_weather_tpu_torch.ops.natten_flash import _NattenFlash

    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    kernel = tuple(int(kk) for kk in kernel)
    circular_w = bool(circular_w)
    _check(q, k, v, kernel, rpb, circular_w)
    tensors = (q, k, v) if rpb is None else (q, k, v, rpb)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if q.device.type == "cpu":
        kernels = natten_flash.KERNELS
        if q.dtype == torch.bfloat16 and _cpu_path(q.shape, kernel, circular_w, rpb, needs_grad,
                                                   impl) != "flash":
            kernels = natten3d.KERNELS
        if needs_grad:
            return _NattenFlash.apply(q, k, v, rpb, kernel, circular_w, kernels)
        return kernels.plain_forward(q, k, v, kernel, rpb, circular_w)[0]
    path = route(tuple(q.shape), kernel, circular_w, rpb is not None, needs_grad, impl)
    if path == "plain":
        return neighborhood_attention_3d_reference(q, k, v, kernel, rpb, circular_w)
    if path == "slot":
        if needs_grad:
            return _NattenFlash.apply(q, k, v, rpb, kernel, circular_w, natten3d.KERNELS)
        return natten3d._forward_cuda(q, k, v, kernel, rpb, circular_w)[0]
    if needs_grad:
        return _NattenFlash.apply(q, k, v, rpb, kernel, circular_w, natten_flash.KERNELS)
    return natten_flash._forward_cuda(q, k, v, kernel, rpb, circular_w, with_lse=False)[0]


def _cpu_path(shape, kernel, circular_w, rpb, needs_grad, impl) -> str:
    """What `route` names for CUDA tensors of `shape`, for CPU tensors in
    bf16, whose plain versions round as the kernel they stand for (flash:
    K5a/K5b's roundings; slot or plain: the slot scan's); "slot" where no
    kernel takes the shape (the JAX package's slot scan runs it)."""
    try:
        return route(tuple(shape), kernel, circular_w, rpb is not None, needs_grad, impl)
    except ValueError:
        return "slot"
