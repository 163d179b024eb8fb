"""The bf16 modes of the port's 3D neighborhood attention against the JAX
package's bf16 runs, on the CPU: the plain versions that the CPU runs and
that the card's bf16 kernels are held to (K6/K6b: the slot scan's roundings;
K5a/K5b: the TPU kernels').

The rule: RMSE(port - JAX bf16) <= r x RMSE(JAX bf16 - JAX f32), the JAX
package's f32 run on the same (f32) inputs being the yardstick of how far
bf16 moves a result. Both get the same numpy inputs, rounded to bf16.

  * Slot path against neighborhood_attention_3d_xla (the scan that the JAX
    package differentiates, and runs on the CPU): r = 0.1 on out, dq, dk,
    dv and drpb. XLA computes q x scale in f32 unrounded (its only use is
    the scan's upcast) and transposes the scan's bf16 gathers: each pair's
    contribution rounded, scattered back along W, then H, then D with every
    sum rounded, added into each key's bf16 sum in reverse slot order.
  * Against the JAX package's K6 (interpret mode): its gradients are the
    scan's (r = 0.1); its forward rounds q x scale to bf16 before the kernel,
    so it is another rounding of the function: the port stays within the
    distance the JAX package's own scan sits from it.
  * Flash path against K5a and K5b (interpret mode): r = 0.1 on out, dq, dk,
    dv and drpb. The TPU kernel sums dk and dv per query tile
    (`natten_flash.tpu_backward_tile`), rounds each tile's part and adds the
    parts in f32; the plain version does the same (rounding each key's sum
    once instead reads ~0.46 and ~0.54 here).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_weather_tpu.ops import neighborhood_attention as jax_na
from graph_weather_tpu.ops.pallas import natten3d as jax_k6
from graph_weather_tpu.ops.pallas import natten_flash as jax_k5
from graph_weather_tpu_torch.ops import natten3d, natten_flash
from graph_weather_tpu_torch.ops.neighborhood_attention import (
    _cpu_path,
    neighborhood_attention_3d,
    ordered_scatter_bf16,
    route,
)

torch.set_num_threads(1)
NAMES = ("out", "dq", "dk", "dv", "drpb")


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def _inputs(shape, heads, ch, kernel, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((*shape, heads, ch)).astype(np.float32) for _ in range(4))
    rpb = (0.5 * rng.standard_normal((heads, *(2 * kk - 1 for kk in kernel)))).astype(np.float32)
    return q, k, v, rpb, dout


@functools.cache
def _jax_runs(which, shape, heads, ch, kernel, circular):
    """(bf16, f32) lists [out, dq, dk, dv, drpb] of the JAX package's `which`
    ("xla", "k6" or "flash") as numpy f32, jax.vjp in one jit."""
    q, k, v, rpb, dout = _inputs(shape, heads, ch, kernel)
    fn = {
        "xla": lambda *a: jax_na.neighborhood_attention_3d_xla(*a[:3], kernel, a[3], circular),
        "k6": lambda *a: jax_k6.neighborhood_attention_3d_pallas(*a[:3], kernel, a[3], circular,
                                                                 interpret=True),
        "flash": lambda *a: jax_na.neighborhood_attention_3d(*a[:3], kernel, a[3], circular,
                                                             impl="flash"),
    }[which]
    runs = []
    for dt in (jnp.bfloat16, jnp.float32):
        @jax.jit
        def vjp(*args):
            out, back = jax.vjp(fn, *args[:4])
            return (out, *back(args[4]))

        res = vjp(*(jnp.asarray(a).astype(dt) for a in (q, k, v, rpb, dout)))
        runs.append([np.asarray(t.astype(jnp.float32)) for t in res])
    return runs


def _port(shape, heads, ch, kernel, circular, impl="auto"):
    """The port's bf16 out and gradients through the CPU dispatcher."""
    q, k, v, rpb, dout = _inputs(shape, heads, ch, kernel)
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_(True) for a in (q, k, v, rpb)]
    out = neighborhood_attention_3d(*leaves[:3], kernel, leaves[3], circular, impl=impl)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout).bfloat16())
    assert out.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    return [t.detach().float().numpy() for t in (out, *grads)]


def _readings(got, runs):
    (want, base) = runs
    return {n: _rmse(a, b) / _rmse(b, c) for n, a, b, c in zip(NAMES, got, want, base)}


SLOT_CASES = [
    ((1, 4, 8, 10), 2, 16, (3, 5, 5), False),
    ((2, 4, 8, 10), 2, 16, (3, 5, 5), True),  # two batch entries: drpb's sum over them
]


@pytest.mark.parametrize("case", SLOT_CASES, ids=["clamped", "circular_b2"])
def test_slot_plain_matches_jax_scan_bf16(case):
    """The slot path in bf16 (impl="pallas": K6/K6b, their plain versions
    here) against the JAX slot scan's bf16 forward and jax.vjp, rule 0.1 on
    out, dq, dk, dv and drpb."""
    shape, heads, ch, kernel, circular = case
    assert _cpu_path((*shape, heads, ch), kernel, circular, True, True, "pallas") == "slot"
    readings = _readings(_port(*case, impl="pallas"), _jax_runs("xla", *case))
    assert all(r <= 0.1 for r in readings.values()), readings


def test_slot_plain_matches_jax_k6_bf16():
    """The slot plain version against the JAX package's K6 in bf16 (interpret
    mode, 4 x 32 at (3, 5, 5), impl="pallas"): its gradients, the scan's,
    within rule 0.1; its forward, which rounds q x scale to bf16 first, no
    further from the port's than from the JAX package's own scan."""
    case = ((1, 4, 8, 12), 4, 32, (3, 5, 5), False)
    q, k, v, rpb, dout = _inputs(*case[:4])
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_(True) for a in (q, k, v, rpb)]
    out = neighborhood_attention_3d(*leaves[:3], case[3], leaves[3], False, impl="pallas")
    got = [t.detach().float().numpy() for t in
           (out, *torch.autograd.grad(out, leaves, torch.from_numpy(dout).bfloat16()))]
    readings = _readings(got, _jax_runs("k6", *case))
    assert all(readings[n] <= 0.1 for n in NAMES[1:]), readings
    k6_out, scan_out = _jax_runs("k6", *case)[0][0], _jax_runs("xla", *case)[0][0]
    assert _rmse(got[0], k6_out) <= 1.1 * _rmse(scan_out, k6_out)


FLASH_CASES = [((1, 4, 8, 12), 4, 32, (3, 5, 5), False)]


@pytest.mark.parametrize("case", FLASH_CASES, ids=["k335"])
def test_flash_plain_matches_jax_k5_bf16(case):
    """The flash path in bf16 (4 x 32 heads: K5a/K5b, their plain versions
    here) against the JAX package's K5a and K5b in bf16 (interpret mode):
    rule 0.1 on out, dq, dk, dv and drpb."""
    shape, heads, ch, kernel, circular = case
    assert route((*shape, heads, ch), kernel, circular, True, True) == "flash"
    readings = _readings(_port(*case), _jax_runs("flash", *case))
    assert all(r <= 0.1 for r in readings.values()), readings


def test_flash_tile_parts_matter(monkeypatch):
    """The TPU kernel's per-tile rounding of dk and dv is what the flash
    plain version mirrors: with the whole volume as one tile the same
    backward reads at least twice as far from the JAX package's dk and dv."""
    case = FLASH_CASES[0]
    runs = _jax_runs("flash", *case)
    mirrored = _readings(_port(*case), runs)
    monkeypatch.setattr(natten_flash, "tpu_backward_tile", lambda *args: None)
    once = _readings(_port(*case), runs)
    for n in ("dk", "dv"):
        assert once[n] >= 2 * mirrored[n], (n, once[n], mirrored[n])


class _Chosen(Exception):
    pass


@pytest.mark.parametrize("dims,heads,ch,kernel,circular,has_bias", [
    ((14, 45, 90), 4, 32, (3, 5, 5), False, True),  # the 128-d WeatherMesh at 1 degree
    ((14, 45, 90), 4, 32, (3, 5, 5), True, True),  # the same, circular in W
    ((14, 15, 30), 4, 32, (3, 5, 5), False, True),  # at 3 degrees
    ((4, 8, 12), 4, 32, (3, 5, 5), False, True),  # FLASH_CASES
    ((4, 8, 12), 4, 32, (3, 5, 5), True, False),
    ((14, 45, 90), 8, 32, (5, 7, 7), False, True),  # a kernel whose halo leaves no tile
], ids=["wm_1deg", "wm_1deg_circular", "wm_3deg", "small", "small_circular_no_rpb", "k577"])
def test_tpu_backward_tile_is_jax_pickers(monkeypatch, dims, heads, ch, kernel, circular, has_bias):
    """natten_flash.tpu_backward_tile, the port's copy of the JAX package's
    bf16 K5b tile choice, picks the tile that `_flash_bwd_impl` picks (its
    layout builder stopped at its first call), or None where it builds
    none."""
    def chosen(d, h, w, kernel_, circular_, th, tw):
        raise _Chosen((th, tw))

    monkeypatch.setattr(jax_k5, "_build_layout", chosen)
    q = jax.ShapeDtypeStruct((1, *dims, heads, ch), jnp.bfloat16)
    rpb = jnp.zeros((heads,) + tuple(2 * k - 1 for k in kernel)) if has_bias else None
    try:
        want = jax_k5._flash_bwd_impl(q, None, None, rpb, None, None, None, kernel, circular, True)
    except _Chosen as stop:
        (want,) = stop.args
    assert natten_flash.tpu_backward_tile(dims, kernel, circular, heads, ch, has_bias) == want


@pytest.mark.parametrize("size,k,circular", [(7, 3, False), (5, 5, False), (6, 3, True)])
def test_ordered_scatter_adds_in_index_order(size, k, circular):
    """ordered_scatter_bf16 against a loop over the sources in ascending order
    with each sum rounded to bf16, on a slot's window table."""
    from graph_weather_tpu_torch.ops.neighborhood_attention import _window_indices

    idx = torch.as_tensor(_window_indices(size, k, circular)[0][:, 0], dtype=torch.long)
    src = torch.randn(3, size, 4, generator=torch.Generator().manual_seed(1)).bfloat16().float()
    want = torch.zeros(3, size, 4)
    for i in range(size):
        want[:, idx[i]] = (want[:, idx[i]] + src[:, i]).bfloat16().float()
    assert torch.equal(ordered_scatter_bf16(src, 1, idx, size), want)


def test_bf16_takes_mixed_dtypes_no_further():
    """q, k, v and rpb must share one dtype, f32 or bf16."""
    q = torch.randn(1, 3, 5, 6, 2, 8)
    rpb = torch.zeros(2, 5, 5, 5)
    with pytest.raises(TypeError, match="one dtype"):
        neighborhood_attention_3d(q.bfloat16(), q.bfloat16(), q.bfloat16(), (3, 3, 3), rpb)
    with pytest.raises(TypeError, match="one dtype"):
        neighborhood_attention_3d(q.half(), q.half(), q.half(), (3, 3, 3), rpb.half())
    out = natten3d.neighborhood_attention_3d_slot(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                                                  (3, 3, 3), rpb.bfloat16())
    assert out.dtype == torch.bfloat16
