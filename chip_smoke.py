"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port's serving path at full width: the 1° GraphWeatherForecaster
(64,800 grid points, 78 + 24 features, width 256, 9 processor blocks, the
5,882-cell hex mesh), with random weights from a seed. Phases, one line
each, in order; any failure raises and ends the run with a non-zero exit:

  1. card: nvidia-smi's name and power limit, torch and CUDA versions
  2. build: the CUDA kernels from csrc/ with nvcc, timed
  3. K1 (fused edge MLP) against its plain PyTorch version at the three
     main-path shapes (g2m, latent, m2g), max abs error <= 1e-4, median
     CUDA-event times of both
  4. serve: build the model on cuda, answer 3 requests (B=1), each with
     exactly 11 K1 launches; NormalizedMSELoss; ms per request
  5. the same weights and one request on the CPU (plain versions):
     max abs difference from the card <= 1e-3
  6. a 4-step autoregressive rollout on the card: finite, ms per step

then one JSON line on the kernels, and last {"ok": true, "device": ...}.
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
CPU_TOL = 1e-3  # 11 message-passing rounds of f32 in another order
TIMING_RUNS = 10


def grid(spacing: float) -> list[tuple[float, float]]:
    """bench.py's grid: lat -90..90-spacing, lon 0..360-spacing, row-major."""
    lats = np.arange(-90.0, 90.0, spacing)
    lons = np.arange(0.0, 360.0, spacing)
    return [(float(a), float(b)) for a in lats for b in lons]


def cuda_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median time of fn() on the card from CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_case(edge_mlp, name, bundle, with_dst, gen, width=256):
    """K1 against its plain version on the graph `bundle` at full width."""
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
    return err, ms, plain_ms


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
    from graph_weather_tpu_torch.meshes.hexmesh import get_hexmesh
    from graph_weather_tpu_torch.ops import _build, edge_mlp
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

    # 2. build
    t0 = time.perf_counter()
    _build.load_library("edge_mlp")
    build_s = time.perf_counter() - t0
    ptxas = [
        line.strip() for line in _build.build_log_path("edge_mlp").read_text().splitlines()
        if "registers" in line or "spill" in line
    ] if _build.build_log_path("edge_mlp").exists() else ["(cached build, no log)"]
    print(f"[build] edge_mlp.cu {build_s:.2f} s | " + " | ".join(ptxas), flush=True)

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
    print(f"[k1] per forward (g2m + 9 latent + m2g): kernel_ms={k1_ms:.4f} "
          f"plain_ms={k1_plain_ms:.4f}", flush=True)

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
    edge_mlp.LAUNCHES = 0
    request_ms, losses = [], []
    for features in inputs:
        before = edge_mlp.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = model(features)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = rollout(inputs[0])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 4
    if traj.shape != (4, 1, len(lat_lons), FEATURE_DIM) or not torch.isfinite(traj).all():
        raise AssertionError(f"bad rollout: shape {tuple(traj.shape)}")
    if edge_mlp.LAUNCHES - before != 44:
        raise AssertionError(f"rollout made {edge_mlp.LAUNCHES - before} K1 launches, expected 44")
    print(f"[rollout] 4 steps finite | step_ms {step_ms:.3f}", flush=True)

    kernels = [{
        "name": "fused_edge_mlp",
        "route": "cuda",
        "source": "graph_weather_tpu_torch/csrc/edge_mlp.cu",
        "replaces": "graph_weather_tpu/ops/pallas/edge_mlp.py:84",
        "launches": serve_launches,
        "max_abs_err": max(v[0] for v in k1.values()),
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
    }]
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
