"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port's paths at full width, with random weights from a seed:
the 1° GraphWeatherForecaster's serving path (64,800 grid points, 78 + 24
features, width 256, 9 processor blocks, the 5,882-cell hex mesh), and the
GenCast denoiser (128 x 64 grid, splits-5 icosphere, 4 hops, hidden
(512, 512), 16 blocks, 4 heads, 89 -> 83 features, clustered attention):
serving, the 20-step sampler and AR rollout, and training. Phases, one line
each, in order; any failure raises and ends the run with a non-zero exit:

  1. card: nvidia-smi's name and power limit, torch and CUDA versions
  2. build: every CUDA kernel from csrc/, one nvcc each, all at once, timed
  3. K1 (fused edge MLP) against its plain PyTorch version at the three
     main-path shapes (g2m, latent, m2g), max abs error <= 1e-4, median
     CUDA-event times of both
  4. serve: build the model on cuda, answer 3 requests (B=1), each with
     exactly 11 K1 launches; NormalizedMSELoss; ms per request
  5. the same weights and one request on the CPU (plain versions):
     max abs difference from the card <= 1e-3
  6. a 4-step autoregressive rollout on the card: finite, ms per step
  7. build: clustered_flash.cu's time, registers and spills
  8. K3a (clustered flash attention) against its plain version on the real
     splits-5 layout at c = 128 and c = 512, B = 1: max abs error <= 1e-4,
     empty and padded rows exactly 0; CUDA-event medians of the kernel, the
     plain version and torch's scaled_dot_product_attention on the
     gathered unions (timed only, never used by the port)
  9. denoise: the full-width Denoiser on cuda answers 3 requests (B = 1,
     sigma = 1), each with exactly 16 K3a launches; ms per request
 10. the same weights and one request on the CPU (plain versions): max abs
     difference from the card <= 1e-3
 11. sample: 2 samples of the 20-step sampler, 592 K3a launches each
 12. a 2-step AR sample rollout: finite, ms per AR step
 13. build: clustered_flash_bwd.cu's time, registers and spills
 14. K3c (symmetric) and K3b (general) backward on the real splits-5 layout
     at c = 128 and 512, B = 1: each against the plain backward and against
     each other, max abs error <= 1e-4; exact-zero gradients on empty and
     padded rows; CUDA-event medians of both, the plain version and SDPA's
     backward on the gathered unions (timed only); per train step: sums and
     the bound
 15. train: 3 steps of make_train_step (WeightedMSELoss, clip + AdamW at
     lr 1e-4, noise levels from sample_noise_level), each with exactly 16
     K3a, 16 K3c dq and 16 K3c dk/dv launches and no K3b launch; finite
     loss, parameters changed; ms per step, peak GiB; a profile of one more
     step; then two steps with remat=True (32 K3a launches each), peak GiB
 16. the same weights and one batch, forward and backward on the CPU (plain
     versions): loss within 1e-5 relative, every parameter's gradient within
     1e-3 max|g| of that tensor (floored at 1e-6 of the largest gradient)

then one JSON line on the kernels, the card's name and power limit, and
last {"ok": true, "device": ...}.
Exits non-zero without a CUDA device, or when the port's package is not
beside this file. f32 throughout; TF32 is off.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FEATURE_DIM, AUX_DIM = 78, 24
K1_TOL = 1e-4  # LayerNorm'd O(1) outputs; only the summation order differs
K3A_TOL = 1e-4  # softmax-weighted sums over <= 768 keys in another order
K3_BWD_TOL = 1e-4  # gradient sums over <= 768 keys or 256 receivers in another order
LOSS_RTOL = 1e-5  # the training loss, card against CPU
GRAD_RTOL = 1e-3  # each parameter's gradient, card against CPU, of that tensor's max|g|
CPU_TOL = 1e-3  # 11 message-passing rounds, or 16 attention blocks, of f32 in another order
TIMING_RUNS = 10
# NVIDIA's H100 SXM data sheet (dense, at the 700 W limit): FP32 on the CUDA
# cores, and HBM3. A kernel's bound is the larger of flops / FP32_PEAK and
# bytes / HBM_RATE, for the work these inputs need.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# GenCast: bench.py's _make_denoiser at full size.
GENCAST = dict(
    grid_lon=np.arange(0.0, 360.0, 360.0 / 128), grid_lat=np.linspace(-90.0, 90.0, 64),
    input_features_dim=89, output_features_dim=83, hidden_dims=(512, 512),
    num_blocks=16, num_heads=4, splits=5, num_hops=4, use_edges_features=False,
    attention_impl="clustered_flash",
)
EVALS_PER_SAMPLE = 2 * (20 - 2) + 1


def grid(spacing: float) -> list[tuple[float, float]]:
    """bench.py's grid: lat -90..90-spacing, lon 0..360-spacing, row-major."""
    lats = np.arange(-90.0, 90.0, spacing)
    lons = np.arange(0.0, 360.0, spacing)
    return [(float(a), float(b)) for a in lats for b in lons]


def cuda_ms(fn, runs: int = TIMING_RUNS, batch: int = 5) -> float:
    """Median time of one fn() on the card: CUDA events around `batch`
    launches in a row (so the host's launch overhead overlaps the device's
    work), `runs` times, after one warm-up."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms on the card, what bounds it) for `flops` FP32 operations
    that must move `nbytes` bytes."""
    by_ops, by_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def k1_case(edge_mlp, name, bundle, with_dst, gen, width=256):
    """K1 against its plain version on the graph `bundle` at full width.
    Returns (max abs error, kernel ms, plain ms, flops, bytes)."""
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    k0 = 3 * width
    args = (
        torch.as_tensor(bundle.senders, device=dev),
        torch.as_tensor(bundle.receivers, device=dev),
        rnd(1, bundle.n_senders, width),
        rnd(1, bundle.n_receivers, width) if with_dst else None,
        rnd(bundle.n_edges, width),  # batch-broadcast, as the first round sees it
        rnd(k0, width, scale=k0**-0.5), rnd(width, scale=0.1),
        rnd(width, width, scale=width**-0.5), rnd(width, scale=0.1),
        rnd(width, width, scale=width**-0.5), rnd(width, scale=0.1),
        1.0 + rnd(width, scale=0.1), rnd(width, scale=0.1),
    )
    out = edge_mlp.fused_edge_mlp(*args)
    torch.cuda.synchronize()
    ref = edge_mlp.fused_edge_mlp_reference(*args)
    err = (out - ref).abs().max().item()
    ms = cuda_ms(lambda: edge_mlp.fused_edge_mlp(*args))
    plain_ms = cuda_ms(lambda: edge_mlp.fused_edge_mlp_reference(*args))
    print(
        f"[k1] {name}: E={bundle.n_edges} N_src={bundle.n_senders} "
        f"N_dst={bundle.n_receivers} x_dst={'yes' if with_dst else 'None'} "
        f"max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}",
        flush=True,
    )
    if not (err <= K1_TOL):
        raise AssertionError(f"K1 {name}: max abs error {err} > {K1_TOL}")
    # Per edge: the x_src, x_dst and e rows of layer 1, then two H x H-wide layers.
    in_rows = 3 if with_dst else 2
    flops = 2 * bundle.n_edges * width * (in_rows * width + 2 * width)
    nbytes = sum(t.numel() * t.element_size() for t in args if t is not None)
    nbytes += out.numel() * out.element_size()
    return err, ms, plain_ms, flops, nbytes


def k3a_case(clustered_flash, khop, gen, c, heads=4):
    """K3a against its plain version at the processor's shapes: q/k/v
    [1, nb * block, heads, c] (rows padded once by the processor), on the
    real cluster layout. Returns (max abs error, kernel ms, plain ms, SDPA
    ms, flops, bytes)."""
    ids, masks, block = khop.cluster_ids, khop.cluster_masks, khop.cluster_block
    n_pad = ids.shape[0] * block
    q, k, v = (torch.randn(1, n_pad, heads, c, generator=gen, device="cuda") for _ in range(3))
    args = (q, k, v, ids, masks, block)
    out = clustered_flash.clustered_flash_attention(*args)
    torch.cuda.synchronize()
    ref = clustered_flash.clustered_flash_forward_reference(*args)
    err = (out - ref).abs().max().item()
    empty = ~masks.reshape(n_pad, -1).bool().any(-1)  # no neighbour, or padding
    zeros = bool((out[:, empty] == 0).all())
    ms = cuda_ms(lambda: clustered_flash.clustered_flash_attention(*args))
    plain_ms = cuda_ms(lambda: clustered_flash.clustered_flash_forward_reference(*args))
    # The library yardstick: one SDPA call on the gathered unions, with the
    # adjacency as a boolean mask (gathers outside the timing). Rows without
    # a neighbour give NaN there, so it is timed, never compared.
    nb, u_pad = ids.shape
    q_b = q.reshape(nb, block, heads, c).transpose(1, 2)
    k_b, v_b = (t[0, ids.long()].transpose(1, 2) for t in (k, v))  # [nb, h, U, c]
    attend = masks.bool()[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = cuda_ms(lambda: sdpa(q_b, k_b, v_b, attn_mask=attend))
    print(
        f"[k3a] c={c}: nb={nb} block={block} U_pad={u_pad} heads={heads} "
        f"empty_rows={int(empty.sum())} max_abs_err={err:.3e} empty_rows_zero={zeros} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={sdpa_ms:.4f}",
        flush=True,
    )
    if not (err <= K3A_TOL):
        raise AssertionError(f"K3a c={c}: max abs error {err} > {K3A_TOL}")
    if not zeros:
        raise AssertionError(f"K3a c={c}: rows without a neighbour are not exactly 0")
    # The work these inputs need: q.k and p.v over the real edges.
    n_edges = khop.senders.shape[0]
    flops = 4 * n_edges * heads * c
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, ids, masks, out))
    return err, ms, plain_ms, sdpa_ms, flops, nbytes


def k3_bwd_case(clustered_flash, khop, scatter, gen, c, heads=4):
    """K3c and K3b against the plain backward at the processor's shapes on
    the real cluster layout, after K3a with lse; `scatter` is K3b's inverse
    index of the layout. Returns a dict of errors, times (ms), flops, bytes
    and K3b's launches in the checked call (before the timings)."""
    ids, masks, block = khop.cluster_ids, khop.cluster_masks, khop.cluster_block
    nb, u_pad = ids.shape
    n_pad = nb * block
    q, k, v, dout = (torch.randn(1, n_pad, heads, c, generator=gen, device="cuda") for _ in range(4))
    out, lse = clustered_flash._forward_cuda(q, k, v, ids, masks, block, with_lse=True)
    args = (q, k, v, ids, masks, out, lse, dout, block)

    def k3c():
        return clustered_flash._backward_cuda(*args, True, None)

    def k3b():
        return clustered_flash._backward_cuda(*args, False, scatter)

    before = clustered_flash.GENERAL_BWD_LAUNCHES
    sym, general = k3c(), k3b()
    k3b_launches = clustered_flash.GENERAL_BWD_LAUNCHES - before
    if k3b_launches != 1:
        raise AssertionError(f"the general backward made {k3b_launches} K3b launches, expected 1")
    torch.cuda.synchronize()
    want = clustered_flash.clustered_flash_backward_reference(*args, symmetric=False)

    def err(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b))

    errs = {"k3c": err(sym, want), "k3b": err(general, want), "k3b_vs_k3c": err(general, sym)}
    empty = ~masks.reshape(n_pad, -1).bool().any(-1)  # no neighbour, or padding
    zeros = all(bool((t[:, empty] == 0).all()) for t in (*sym, *general))
    with_lse_ms = cuda_ms(lambda: clustered_flash._forward_cuda(q, k, v, ids, masks, block, True))
    ms = {"k3c": cuda_ms(k3c), "k3b": cuda_ms(k3b)}
    plain = {
        "k3c": cuda_ms(lambda: clustered_flash.clustered_flash_backward_reference(*args, symmetric=True)),
        "k3b": cuda_ms(lambda: clustered_flash.clustered_flash_backward_reference(*args, symmetric=False)),
    }
    # The library yardstick: SDPA's backward on the gathered unions with the
    # adjacency as a boolean mask (gathers and forward outside the timing);
    # rows without a neighbour give NaN there, so it is timed, never compared.
    q_b = q.reshape(nb, block, heads, c).transpose(1, 2).detach().requires_grad_(True)
    k_b, v_b = (t[0, ids.long()].transpose(1, 2).detach().requires_grad_(True) for t in (k, v))
    do_b = dout.reshape(nb, block, heads, c).transpose(1, 2)
    o_b = torch.nn.functional.scaled_dot_product_attention(q_b, k_b, v_b, attn_mask=masks.bool()[:, None])
    sdpa_ms = cuda_ms(lambda: torch.autograd.grad(o_b, (q_b, k_b, v_b), do_b, retain_graph=True))
    print(
        f"[k3_bwd] c={c}: max_abs_err K3c {errs['k3c']:.3e} K3b {errs['k3b']:.3e} "
        f"K3b-K3c {errs['k3b_vs_k3c']:.3e} | empty_rows {int(empty.sum())} zero_grads={zeros} "
        f"| K3c_ms={ms['k3c']:.4f} K3b_ms={ms['k3b']:.4f} plain_ms K3c {plain['k3c']:.4f} "
        f"K3b {plain['k3b']:.4f} sdpa_bwd_ms={sdpa_ms:.4f} | K3a with lse ms={with_lse_ms:.4f}",
        flush=True,
    )
    for name, e in errs.items():
        if not (e <= K3_BWD_TOL):
            raise AssertionError(f"{name} c={c}: max abs error {e} > {K3_BWD_TOL}")
    if not zeros:
        raise AssertionError(f"K3b/K3c c={c}: rows without a neighbour have non-zero gradients")
    # The work these inputs need: s, dp, dq, dk and dv over the real edges.
    flops = 10 * khop.senders.shape[0] * heads * c
    nbytes = sum(t.numel() * t.element_size() for t in (*args[:-1], *sym))
    return dict(errs=errs, ms=ms, plain=plain, sdpa_ms=sdpa_ms, flops=flops, nbytes=nbytes,
                k3b_launches=k3b_launches)


def grads_close(card: dict, cpu: dict) -> tuple[float, str]:
    """Worst (error / limit) over the parameters, and its name: each
    gradient within GRAD_RTOL of its tensor's max|g| on the CPU, floored at
    1e-6 of the largest gradient (the k projection's bias has an exactly-zero
    gradient: a shift of every key's logit cancels in the softmax)."""
    floor = 1e-6 * max(g.abs().max().item() for g in cpu.values())
    worst, name = 0.0, ""
    for key, g in cpu.items():
        limit = max(GRAD_RTOL * g.abs().max().item(), floor)
        ratio = (card[key] - g).abs().max().item() / limit
        if ratio > worst:
            worst, name = ratio, key
    return worst, name


def timed(fn):
    """(fn(), host ms) around work that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profile_request(fn, what: str = "request") -> None:
    """One more request (or train step) under torch.profiler: device time by
    kernel, and the device's busy share of its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_ms = timed(fn)
    by_name: dict[str, list] = {}
    for e in prof.events():
        # Device kernels and copies; not the user-annotation ranges (as
        # Optimizer.step) that the profiler also files under the device.
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
    if not by_name:
        print("[profile] no device events recorded: device time not measured", flush=True)
        return
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"[profile] {what} wall_ms {wall_ms:.3f} | device busy_ms {busy_ms:.3f} "
          f"({100 * busy_ms / wall_ms:.1f}%) | {sum(n for _, n in by_name.values())} kernels | "
          + " | ".join(f"{name[:60]} {ms:.3f} ms x{n}" for name, (ms, n) in top), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import graph_weather_tpu_torch as port

    if not Path(port.__file__).resolve().is_relative_to(ROOT):
        raise ImportError(f"graph_weather_tpu_torch imported from {port.__file__}, not {ROOT}")
    from graph_weather_tpu_torch.meshes.graphs import (
        build_grid_to_mesh_graph,
        build_latent_graph,
        build_mesh_to_grid_graph,
    )
    from graph_weather_tpu_torch.meshes.clustering import build_cluster_scatter_index
    from graph_weather_tpu_torch.meshes.hexmesh import get_hexmesh
    from graph_weather_tpu_torch.models.gencast.graphs import build_graphcast_graphs
    from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
    from graph_weather_tpu_torch.ops import _build, clustered_flash, edge_mlp
    from graph_weather_tpu_torch.train.rollout import make_rollout_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = smi
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| devices {torch.cuda.device_count()}", flush=True)

    # 2. build (all kernels at once; phase 7 reports the second)
    t0 = time.perf_counter()
    _build.load_libraries(["edge_mlp", "clustered_flash", "clustered_flash_bwd"])
    build_s = time.perf_counter() - t0

    def ptxas(name):
        log = _build.build_log_path(name)
        if not log.exists():
            return ["(cached build, no log)"]
        return [line.strip() for line in log.read_text().splitlines()
                if "registers" in line or "spill" in line]

    print(f"[build] edge_mlp.cu {build_s:.2f} s | " + " | ".join(ptxas("edge_mlp")), flush=True)

    # 3. K1 at the main-path shapes, on the real 1° graphs
    lat_lons = grid(1.0)
    ll = np.asarray(lat_lons)
    mesh = get_hexmesh(2)
    g2m, latent, m2g = (
        build_grid_to_mesh_graph(ll, mesh),
        build_latent_graph(mesh),
        build_mesh_to_grid_graph(ll, mesh),
    )
    sizes = (g2m.n_edges, latent.n_edges, m2g.n_edges)
    if sizes != (64800, 41162, 452460):
        raise AssertionError(f"1° graph edge counts {sizes}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = {
        name: k1_case(edge_mlp, name, bundle, with_dst, gen)
        for name, bundle, with_dst in (
            ("g2m", g2m, True), ("latent", latent, True), ("m2g", m2g, False)
        )
    }
    per_forward = {"g2m": 1, "latent": 9, "m2g": 1}  # launches per forward
    k1_ms = sum(k1[n][1] * c for n, c in per_forward.items())
    k1_plain_ms = sum(k1[n][2] * c for n, c in per_forward.items())
    k1_bound_ms = sum(bound(*k1[n][3:])[0] * c for n, c in per_forward.items())
    k1_bound_by = bound(*k1["m2g"][3:])[1]
    print(f"[k1] per forward (g2m + 9 latent + m2g): kernel_ms={k1_ms:.4f} "
          f"plain_ms={k1_plain_ms:.4f} bound_ms={k1_bound_ms:.4f} ({k1_bound_by})", flush=True)

    # 4. serve
    t0 = time.perf_counter()
    model = port.GraphWeatherForecaster(
        lat_lons, feature_dim=FEATURE_DIM, aux_dim=AUX_DIM, device="cuda"
    )
    model.init(torch.Generator().manual_seed(0))
    setup_s = time.perf_counter() - t0
    inputs = torch.randn(
        3, 1, len(lat_lons), FEATURE_DIM + AUX_DIM, generator=torch.Generator().manual_seed(1)
    ).to("cuda")
    loss_fn = port.NormalizedMSELoss(np.ones(FEATURE_DIM), lat_lons, device="cuda")
    edge_mlp.LAUNCHES = clustered_flash.LAUNCHES = 0
    request_ms, losses = [], []
    for features in inputs:
        before = edge_mlp.LAUNCHES
        pred, ms = timed(lambda: model(features))
        request_ms.append(ms)
        if edge_mlp.LAUNCHES - before != 11:
            raise AssertionError(f"{edge_mlp.LAUNCHES - before} K1 launches, expected 11")
        if pred.shape != (1, len(lat_lons), FEATURE_DIM) or not torch.isfinite(pred).all():
            raise AssertionError(f"bad prediction: shape {tuple(pred.shape)}")
        losses.append(loss_fn(pred, features[..., :FEATURE_DIM]).item())
    serve_launches = edge_mlp.LAUNCHES
    print(f"[serve] setup {setup_s:.2f} s | request_ms {[round(t, 3) for t in request_ms]} "
          f"| K1 launches {serve_launches} | loss {[round(v, 6) for v in losses]}", flush=True)

    # 5. the same weights and the last request on the CPU
    cpu_model = port.GraphWeatherForecaster(
        lat_lons, feature_dim=FEATURE_DIM, aux_dim=AUX_DIM, device="cpu"
    )
    cpu_model.module.load_state_dict({k: v.cpu() for k, v in model.module.state_dict().items()})
    t0 = time.perf_counter()
    cpu_pred = cpu_model(features.cpu())
    cpu_s = time.perf_counter() - t0
    cpu_err = (pred.cpu() - cpu_pred).abs().max().item()
    print(f"[cpu] max_abs_diff {cpu_err:.3e} (limit {CPU_TOL}) | cpu forward {cpu_s:.2f} s",
          flush=True)
    if not (cpu_err <= CPU_TOL):
        raise AssertionError(f"card vs CPU: {cpu_err} > {CPU_TOL}")

    # 6. rollout
    rollout = make_rollout_fn(model, 4)
    before = edge_mlp.LAUNCHES
    traj, ms = timed(lambda: rollout(inputs[0]))
    step_ms = ms / 4
    if traj.shape != (4, 1, len(lat_lons), FEATURE_DIM) or not torch.isfinite(traj).all():
        raise AssertionError(f"bad rollout: shape {tuple(traj.shape)}")
    if edge_mlp.LAUNCHES - before != 44:
        raise AssertionError(f"rollout made {edge_mlp.LAUNCHES - before} K1 launches, expected 44")
    print(f"[rollout] 4 steps finite | step_ms {step_ms:.3f}", flush=True)
    del model, cpu_model, traj

    # 7. build of the GenCast kernel (started with the others in phase 2)
    print(f"[build] clustered_flash.cu {build_s:.2f} s (parallel with edge_mlp.cu) | "
          + " | ".join(ptxas("clustered_flash")), flush=True)

    # 8. K3a on the real splits-5 layout, at the processor's two head widths
    t0 = time.perf_counter()
    graphs = build_graphcast_graphs(
        GENCAST["grid_lon"], GENCAST["grid_lat"], splits=5, num_hops=4,
        add_edge_features_to_khop=False, spatial_sort="rcb",
    )
    khop = DeviceGraph.from_bundle(graphs.khop, "cuda", clustered=True)
    graph_s = time.perf_counter() - t0
    nb, u_pad = khop.cluster_ids.shape
    block = khop.cluster_block

    def empty_tiles(tq, tk):  # share of (query tile, key tile) pairs without an edge
        m = khop.cluster_masks.bool().reshape(nb, block // tq, tq, u_pad // tk, tk)
        return 1.0 - m.any(4).any(2).float().mean().item()

    print(f"[k3a] graphs (SciPy k-hop) + layout {graph_s:.2f} s | k-hop edges "
          f"{graphs.khop.n_edges} | g2m {graphs.g2m.n_edges} | m2g {graphs.m2g.n_edges} | "
          f"nb {nb} | U_pad {u_pad} | mask density "
          f"{khop.cluster_masks.float().mean().item():.4f} | empty key tiles "
          f"64x64 {empty_tiles(64, 64):.4f} 32x32 {empty_tiles(32, 32):.4f}", flush=True)
    k3a = {c: k3a_case(clustered_flash, khop, gen, c) for c in (128, 512)}
    per_eval = {128: GENCAST["num_blocks"] - 1, 512: 1}  # launches per denoiser evaluation

    def per_eval_sum(values):
        return sum(values[c] * n for c, n in per_eval.items())

    k3a_ms = per_eval_sum({c: v[1] for c, v in k3a.items()})
    k3a_plain_ms = per_eval_sum({c: v[2] for c, v in k3a.items()})
    k3a_sdpa_ms = per_eval_sum({c: v[3] for c, v in k3a.items()})
    k3a_bound_ms = per_eval_sum({c: bound(*v[4:])[0] for c, v in k3a.items()})
    k3a_bound_by = bound(*k3a[128][4:])[1]
    dense_flops = per_eval_sum({c: 4 * nb * 256 * u_pad * c * 4 for c in per_eval})
    print(f"[k3a] per denoiser eval (15 x c=128 + c=512): kernel_ms={k3a_ms:.4f} "
          f"plain_ms={k3a_plain_ms:.4f} sdpa_ms={k3a_sdpa_ms:.4f} bound_ms={k3a_bound_ms:.4f} "
          f"({k3a_bound_by}, edges only) | dense (row, slot) work {dense_flops / 1e9:.1f} GFLOP "
          f"= {dense_flops / FP32_PEAK * 1e3:.3f} ms at the FP32 peak", flush=True)

    # 9. denoise: the full-width Denoiser answers 3 requests
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    den = port.Denoiser(**GENCAST, device="cuda")
    den.init(torch.Generator().manual_seed(0))
    setup_s = time.perf_counter() - t0
    data_gen = torch.Generator().manual_seed(1)
    n_lon, n_lat, f_in, f_out = 128, 64, GENCAST["input_features_dim"], GENCAST["output_features_dim"]
    corrupted = torch.randn(3, 1, n_lon, n_lat, f_out, generator=data_gen).to("cuda")
    prev = torch.randn(3, 1, n_lon, n_lat, 2 * f_in, generator=data_gen).to("cuda")
    sigma = torch.ones(1, 1, device="cuda")
    edge_mlp.LAUNCHES = clustered_flash.LAUNCHES = 0
    denoise_ms = []
    for x, cond in zip(corrupted, prev):
        before = clustered_flash.LAUNCHES
        out, ms = timed(lambda: den(x, cond, sigma))
        denoise_ms.append(ms)
        if clustered_flash.LAUNCHES - before != GENCAST["num_blocks"]:
            raise AssertionError(f"{clustered_flash.LAUNCHES - before} K3a launches, expected 16")
        if out.shape != (1, n_lon, n_lat, f_out) or not torch.isfinite(out).all():
            raise AssertionError(f"bad denoiser output: shape {tuple(out.shape)}")
    denoise_launches = clustered_flash.LAUNCHES
    if edge_mlp.LAUNCHES:
        raise AssertionError("the GenCast path launched K1")
    print(f"[denoise] setup {setup_s:.2f} s | request_ms {[round(t, 3) for t in denoise_ms]} "
          f"| K3a launches {denoise_launches} | peak GiB "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", flush=True)
    profile_request(lambda: den(x, cond, sigma))

    # 10. the same weights and the last request on the CPU
    cpu_den = port.Denoiser(**GENCAST, device="cpu")
    cpu_den.module.load_state_dict({k: v.cpu() for k, v in den.module.state_dict().items()})
    t0 = time.perf_counter()
    cpu_out = cpu_den(x.cpu(), cond.cpu(), sigma.cpu())
    cpu_s = time.perf_counter() - t0
    cpu_err = (out.cpu() - cpu_out).abs().max().item()
    print(f"[cpu] denoiser max_abs_diff {cpu_err:.3e} (limit {CPU_TOL}) | cpu forward "
          f"{cpu_s:.2f} s", flush=True)
    if not (cpu_err <= CPU_TOL):
        raise AssertionError(f"denoiser card vs CPU: {cpu_err} > {CPU_TOL}")
    del cpu_den

    # 11. sample: 2 samples of the 20-step sampler
    sampler = port.Sampler(num_steps=20, device="cuda")
    noise_gen = torch.Generator(device="cuda").manual_seed(2)
    sample_ms = []
    for _ in range(2):
        before = clustered_flash.LAUNCHES
        sample, ms = timed(lambda: sampler.sample(den, prev[0], noise_gen))
        sample_ms.append(ms)
        launches = clustered_flash.LAUNCHES - before
        if launches != EVALS_PER_SAMPLE * GENCAST["num_blocks"]:
            raise AssertionError(f"a sample made {launches} K3a launches, expected 592")
        if sample.shape != (1, n_lon, n_lat, f_out) or not torch.isfinite(sample).all():
            raise AssertionError(f"bad sample: shape {tuple(sample.shape)}")
    print(f"[sample] 2 x 20 steps ({EVALS_PER_SAMPLE} evals) finite | sample_ms "
          f"{[round(t, 3) for t in sample_ms]} | ms per eval {sample_ms[-1] / EVALS_PER_SAMPLE:.3f} "
          f"| K3a launches {launches} per sample", flush=True)

    # 12. a 2-step AR sample rollout
    ar = port.make_ar_rollout_fn(sampler, den, 2, device="cuda")
    traj, ms = timed(lambda: ar(prev[0], noise_gen))
    if traj.shape != (2, 1, n_lon, n_lat, f_out) or not torch.isfinite(traj).all():
        raise AssertionError(f"bad AR rollout: shape {tuple(traj.shape)}")
    print(f"[ar_rollout] 2 steps finite | ms per AR step {ms / 2:.3f}", flush=True)

    # 13. build of the backward kernels (started with the others in phase 2)
    print(f"[build] clustered_flash_bwd.cu {build_s:.2f} s (parallel with the others) | "
          + " | ".join(ptxas("clustered_flash_bwd")), flush=True)

    # 14. K3c and K3b on the real splits-5 layout, at both head widths
    # The k-hop graph is symmetric, so its DeviceGraph carries no inverse
    # index; K3b's comes from the layout here, outside the timings.
    scatter = torch.as_tensor(build_cluster_scatter_index(
        khop.cluster_ids.cpu().numpy(), khop.cluster_masks.cpu().numpy(), khop.n_senders
    ), device="cuda")
    bwd = {c: k3_bwd_case(clustered_flash, khop, scatter, gen, c) for c in (128, 512)}
    k3b_phase14 = sum(v["k3b_launches"] for v in bwd.values())
    k3c_ms = per_eval_sum({c: v["ms"]["k3c"] for c, v in bwd.items()})
    k3b_ms = per_eval_sum({c: v["ms"]["k3b"] for c, v in bwd.items()})
    k3c_plain_ms = per_eval_sum({c: v["plain"]["k3c"] for c, v in bwd.items()})
    k3b_plain_ms = per_eval_sum({c: v["plain"]["k3b"] for c, v in bwd.items()})
    bwd_sdpa_ms = per_eval_sum({c: v["sdpa_ms"] for c, v in bwd.items()})
    bwd_bound_ms = per_eval_sum({c: bound(v["flops"], v["nbytes"])[0] for c, v in bwd.items()})
    bwd_bound_by = bound(bwd[128]["flops"], bwd[128]["nbytes"])[1]
    dense_bwd = per_eval_sum({c: 7 * 2 * nb * 256 * u_pad * c * 4 for c in per_eval})
    print(f"[k3_bwd] per train step (15 x c=128 + c=512): K3c_ms={k3c_ms:.4f} K3b_ms={k3b_ms:.4f} "
          f"plain_ms K3c {k3c_plain_ms:.4f} K3b {k3b_plain_ms:.4f} sdpa_bwd_ms={bwd_sdpa_ms:.4f} "
          f"bound_ms={bwd_bound_ms:.4f} ({bwd_bound_by}, edges only) | dense (row, slot) work of "
          f"K3c's 7 products {dense_bwd / 1e9:.1f} GFLOP = {dense_bwd / FP32_PEAK * 1e3:.3f} ms at "
          f"the FP32 peak", flush=True)

    # 15. train: 3 steps of the full-width denoiser (the weights of phase 9)
    train_gen = torch.Generator().manual_seed(3)
    corrupted_t, prev_t, target_t = (
        torch.randn(1, n_lon, n_lat, f, generator=train_gen).to("cuda") for f in (f_out, 2 * f_in, f_out)
    )
    noise_t = port.sample_noise_level(torch.Generator(device="cuda").manual_seed(4), (1, 1))
    train_loss = port.WeightedMSELoss(grid_lat=GENCAST["grid_lat"], device="cuda")

    def objective(pred, target):
        return train_loss(pred, noise_t, target)

    def counts():
        return (clustered_flash.LAUNCHES, clustered_flash.SYMMETRIC_DQ_LAUNCHES,
                clustered_flash.SYMMETRIC_DKV_LAUNCHES, clustered_flash.GENERAL_BWD_LAUNCHES)

    def train_steps(model, n_steps, per_step):
        """n_steps of make_train_step on `model`; each must make `per_step`
        (K3a, K3c dq, K3c dk/dv, K3b) launches. Returns (ms, losses)."""
        step = port.make_train_step(
            model.module.parameters(), model.forward_fn(), objective, port.make_optimizer(1e-4)
        )
        step_ms, losses = [], []
        for _ in range(n_steps):
            before = counts()
            loss, ms = timed(lambda: step(corrupted_t, prev_t, noise_t, target_t))
            made = tuple(a - b for a, b in zip(counts(), before))
            if made != per_step:
                raise AssertionError(f"a train step made {made} (K3a, K3c dq, K3c dk/dv, K3b) "
                                     f"launches, expected {per_step}")
            if not torch.isfinite(loss):
                raise AssertionError(f"train loss {loss.item()}")
            step_ms.append(ms)
            losses.append(loss.item())
        return step, step_ms, losses

    blocks = GENCAST["num_blocks"]
    before = [t.detach().clone() for t in den.module.parameters()]
    torch.cuda.reset_peak_memory_stats()
    clustered_flash.LAUNCHES = clustered_flash.SYMMETRIC_DQ_LAUNCHES = 0
    clustered_flash.SYMMETRIC_DKV_LAUNCHES = clustered_flash.GENERAL_BWD_LAUNCHES = 0
    step, train_ms, train_losses = train_steps(den, 3, (blocks, blocks, blocks, 0))
    train_launches = counts()
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    unchanged = [i for i, (a, b) in enumerate(zip(before, den.module.parameters())) if torch.equal(a, b)]
    if unchanged:
        raise AssertionError(f"{len(unchanged)} parameter tensors did not change in 3 train steps")
    print(f"[train] 3 steps | step_ms {[round(t, 3) for t in train_ms]} | steady median "
          f"{statistics.median(train_ms[1:]):.3f} | loss {[round(v, 6) for v in train_losses]} "
          f"| sigma {noise_t.item():.4f} | launches per step K3a {blocks} K3c dq {blocks} "
          f"K3c dk/dv {blocks} K3b 0 | all {len(before)} parameter tensors changed | "
          f"peak GiB {train_peak:.2f}", flush=True)
    profile_request(lambda: step(corrupted_t, prev_t, noise_t, target_t), "train step")
    del step
    remat = port.Denoiser(**GENCAST, remat=True, device="cuda")
    remat.module.load_state_dict(den.module.state_dict())
    torch.cuda.reset_peak_memory_stats()
    _, remat_ms, remat_loss = train_steps(remat, 2, (2 * blocks, blocks, blocks, 0))
    print(f"[train] remat=True: 2 steps | step_ms {[round(t, 3) for t in remat_ms]} | loss "
          f"{[round(v, 6) for v in remat_loss]} | K3a launches {2 * blocks} per step | peak GiB "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} (with the first model's weights and "
          f"optimizer state resident)", flush=True)
    del remat

    # 16. the same weights and batch: gradients on the card and on the CPU
    den.module.zero_grad(set_to_none=True)
    card_value = objective(den.forward_fn()(corrupted_t, prev_t, noise_t), target_t)
    card_value.backward()
    card_grads = {k: t.grad.cpu() for k, t in den.module.named_parameters()}
    cpu_den = port.Denoiser(**GENCAST, device="cpu")
    cpu_den.module.load_state_dict({k: v.cpu() for k, v in den.module.state_dict().items()})
    cpu_loss = port.WeightedMSELoss(grid_lat=GENCAST["grid_lat"], device="cpu")
    t0 = time.perf_counter()
    cpu_value = cpu_loss(cpu_den.forward_fn()(corrupted_t.cpu(), prev_t.cpu(), noise_t.cpu()),
                         noise_t.cpu(), target_t.cpu())
    cpu_value.backward()
    cpu_s = time.perf_counter() - t0
    cpu_grads = {k: t.grad for k, t in cpu_den.module.named_parameters()}
    loss_rel = abs(card_value.item() - cpu_value.item()) / abs(cpu_value.item())
    worst, worst_name = grads_close(card_grads, cpu_grads)
    print(f"[cpu] train loss card {card_value.item():.6f} cpu {cpu_value.item():.6f} rel "
          f"{loss_rel:.3e} (limit {LOSS_RTOL}) | gradients: worst error / limit {worst:.3e} "
          f"({worst_name}) over {len(cpu_grads)} tensors | cpu forward+backward {cpu_s:.2f} s",
          flush=True)
    if not (loss_rel <= LOSS_RTOL):
        raise AssertionError(f"train loss card vs CPU: {loss_rel} > {LOSS_RTOL}")
    if not (worst <= 1.0):
        raise AssertionError(f"gradient of {worst_name} card vs CPU: {worst} x its limit")
    del cpu_den

    kernels = [
        {
            "name": "fused_edge_mlp",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/edge_mlp.cu",
            "replaces": "graph_weather_tpu/ops/pallas/edge_mlp.py:84",
            "launches": serve_launches,
            "max_abs_err": max(v[0] for v in k1.values()),
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound_ms,
            "bound_by": k1_bound_by,
            "library_ms": None,  # no single PyTorch call computes the fused edge MLP
        },
        {
            "name": "clustered_flash_attention",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/clustered_flash.cu",
            "replaces": "graph_weather_tpu/ops/pallas/clustered_flash.py:427",
            "launches": denoise_launches,
            "max_abs_err": max(v[0] for v in k3a.values()),
            "ms": k3a_ms,
            "plain_ms": k3a_plain_ms,
            "bound_ms": k3a_bound_ms,
            "bound_by": k3a_bound_by,
            "library_ms": k3a_sdpa_ms,
            "sdpa_ms": k3a_sdpa_ms,
            "train_launches": train_launches[0],  # 3 train steps, with lse
        },
        {
            "name": "clustered_flash_backward_general",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/clustered_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/clustered_flash.py:560",
            "launches": train_launches[3],  # the k-hop graph is symmetric: K3c, not K3b
            "launches_phase14": k3b_phase14,  # counted over the checked call at each width
            "max_abs_err": max(max(v["errs"]["k3b"], v["errs"]["k3b_vs_k3c"]) for v in bwd.values()),
            "ms": k3b_ms,
            "plain_ms": k3b_plain_ms,
            "bound_ms": bwd_bound_ms,
            "bound_by": bwd_bound_by,
            "library_ms": bwd_sdpa_ms,
        },
        {
            "name": "clustered_flash_backward_symmetric",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/clustered_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/clustered_flash.py:749",
            "launches": train_launches[1],  # dq kernel; as many of the dk/dv kernel
            "launches_dkv": train_launches[2],
            "max_abs_err": max(v["errs"]["k3c"] for v in bwd.values()),
            "ms": k3c_ms,
            "plain_ms": k3c_plain_ms,
            "bound_ms": bwd_bound_ms,
            "bound_by": bwd_bound_by,
            "library_ms": bwd_sdpa_ms,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)  # nvidia-smi's "name, power.limit", as it printed them
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
