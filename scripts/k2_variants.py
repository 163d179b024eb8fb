"""What holds the forecaster's fused edge update, K2 (csrc/edge_mlp.cu,
partial-product mode) and its backward K2b (csrc/fused_mlp_bwd.cu), on an
NVIDIA GPU: builds both sources again over copies of csrc/edge_tile.cuh
with one change each and times each build at the 1-degree forecaster's
shapes (g2m 64,800 edges, latent 41,162, m2g 452,460 without a destination
term; width 256; per forward or train step: g2m + 9 latent + m2g), against
the plain versions.

    python3 scripts/k2_variants.py [--out DIR] [--only NAME,NAME,...] [--readings]

Variants (edits of edge_tile.cuh):
  mt4        as the port builds it: 8 warps of 64 rows x 32 columns, 16-row
             weight slices in two stages, each B fragment split (ctile::split)
             in the inner loop; two blocks an SM
  mt2        32 x 64 warp tiles
  mt1        16 x 128 warp tiles: each B fragment meets one A fragment
  trunc      the small parts left for the mma to truncate (three
             instructions a split, not five)
  fourth     the small . small products added too (four mma a product)
  kc8_s4     8-row slices in a ring of four stages (three in flight)
  kc8_s4_mt2 the same with 32 x 64 warp tiles
  kc32       32-row slices in two stages (one block an SM)

Each variant's sources are written to DIR/NAME and built there with nvcc
(DIR: default graph_weather_tpu_torch/_build/k2_variants, beside the port's
own builds), held against the plain versions at the g2m shape (K2 within 1e-4; K2b's recomputed h0/h1 within
1e-4 and each gradient within 1e-4 of its max|g|, at the kernel's ReLU
masks), and timed by chip_smoke.cuda_ms (CUDA events around batches of 5
launches). Prints one line per variant: K2 per forward and K2b per train
step (the kernel alone), per-shape times, errors, and ptxas's registers and
spills. f32; TF32 is off outside the kernels.

--readings: then, for each variant, chip_smoke.py phase 35's reading at the
forecaster's initial weights (the same model, batch and rule: the card's
gradients against the CPU's float32 and float64 ones, each tensor outside
GRAD_RTOL as its card error over F32_NOISE_FACTOR times the CPU float32's
error against float64; 1.0 is the limit). The CPU gradients take ~40 s.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
TILE = ROOT / "graph_weather_tpu_torch" / "csrc" / "edge_tile.cuh"
# The small part passed as it is, for the mma to truncate.
TRUNC_SPLIT = """__device__ __forceinline__ void split_trunc(float x, uint32_t& big, uint32_t& small) {
  big = ctile::rna_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ FragA load_a_trunc(const float* tile, int ld, int k0, int lane) {
  const float* p = tile + (lane >> 2) * ld + k0 + (lane & 3);
  FragA a;
  split_trunc(p[0], a.big[0], a.small[0]);
  split_trunc(p[8 * ld], a.big[1], a.small[1]);
  split_trunc(p[4], a.big[2], a.small[2]);
  split_trunc(p[8 * ld + 4], a.big[3], a.small[3]);
  return a;
}

// acc += A[:, k0 : k0 + KC) . slice over the warp's tiles."""
MMA = "        ctile::mma_tf32(acc[mt][nt], a[mt].small, bb);"
VARIANTS = {  # name: [(text in edge_tile.cuh, its replacement)]
    "mt4": [],
    "mt2": [("constexpr int MT = 4;", "constexpr int MT = 2;")],
    "mt1": [("constexpr int MT = 4;", "constexpr int MT = 1;")],
    "trunc": [("// acc += A[:, k0 : k0 + KC) . slice over the warp's tiles.", TRUNC_SPLIT),
              ("ctile::load_a(A", "load_a_trunc(A"), ("ctile::split(b[", "split_trunc(b[")],
    "fourth": [(MMA, MMA.replace("bb);", "bs);") + "\n" + MMA)],
    "kc8_s4": [("constexpr int KC = 16;", "constexpr int KC = 8;"),
               ("constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    "kc8_s4_mt2": [("constexpr int KC = 16;", "constexpr int KC = 8;"),
                   ("constexpr int STAGES = 2;", "constexpr int STAGES = 4;"),
                   ("constexpr int MT = 4;", "constexpr int MT = 2;")],
    "kc32": [("constexpr int KC = 16;", "constexpr int KC = 32;")],
}
SOURCES = ("edge_mlp", "fused_mlp_bwd")


def build(out: Path, names: list[str], build_mod) -> dict:
    """Every (variant, source) library, one nvcc each, all at once. Returns
    {(variant, source): (CDLL, ptxas lines)}."""
    procs = {}
    for name in names:
        tile = TILE.read_text()
        for old, new in VARIANTS[name]:
            if old not in tile:
                raise ValueError(f"variant {name}: edge_tile.cuh no longer holds {old!r}")
            tile = tile.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / TILE.name).write_text(tile)
        for src in SOURCES:
            (d / f"{src}.cu").write_text((build_mod.CSRC_DIR / f"{src}.cu").read_text())
            so = d / f"{src}.so"
            cmd = [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-I", str(build_mod.CSRC_DIR),
                   "-o", str(so), str(d / f"{src}.cu")]
            procs[name, src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        libs[key] = (ctypes.CDLL(str(so)), ptxas)
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=ROOT / "graph_weather_tpu_torch" / "_build" / "k2_variants")
    parser.add_argument("--only", default=None)
    parser.add_argument("--readings", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device; this script times kernels on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from graph_weather_tpu_torch.meshes.graphs import (
        build_grid_to_mesh_graph,
        build_latent_graph,
        build_mesh_to_grid_graph,
    )
    from graph_weather_tpu_torch.meshes.hexmesh import get_hexmesh
    from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
    from graph_weather_tpu_torch.ops import _build, fused_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    names = args.only.split(",") if args.only else list(VARIANTS)
    libs = build(args.out, names, _build)
    print(f"[k2_variants] {card} | torch {torch.__version__}", flush=True)

    ll = np.asarray(cs.grid(1.0))
    mesh = get_hexmesh(2)
    graphs = {
        name: DeviceGraph.from_bundle(bundle, "cuda", edge_sums=True)
        for name, bundle in (("g2m", build_grid_to_mesh_graph(ll, mesh)),
                             ("latent", build_latent_graph(mesh)),
                             ("m2g", build_mesh_to_grid_graph(ll, mesh)))
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for name, graph in graphs.items():
        a = cs.k2_inputs(graph, name != "m2g", gen)
        inputs[name] = (a, torch.randn(1, graph.senders.shape[0], 256, generator=gen, device="cuda"))
    def c_function_of(variant):
        def c_function(library, fn_name, argtypes):
            fn = getattr(libs[variant, library][0], fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            return fn
        return c_function

    own_c_function = fused_mlp.c_function
    try:
        for variant in names:
            fused_mlp.c_function = c_function_of(variant)
            # Errors at the g2m shape (the plain backward at the kernel's masks).
            a, dout = inputs["g2m"]
            tables = (graphs["g2m"].sender_sum, graphs["g2m"].receiver_sum)
            out = fused_mlp._forward_cuda(*a)
            torch.cuda.synchronize()
            fwd_err = (out - fused_mlp.fused_edge_update_reference(*a)).abs().max().item()
            (h0, h1, *_), _ = fused_mlp.launch_backward(*a[:12], dout)
            plain = fused_mlp.fused_edge_update_activations(*a[:9])
            act_err = max((x - y).abs().max().item() for x, y in zip((h0, h1), plain))
            got = fused_mlp._backward_cuda(*a, dout, *tables)
            want = fused_mlp.fused_edge_update_backward_reference(*a, dout, *tables, activations=(h0, h1))
            bwd_err = max((g - w).abs().max().item() / w.abs().max().item()
                          for g, w in zip(got, want) if w is not None)
            del out, h0, h1, plain, got, want
            ms = {}
            for name, (a, dout) in inputs.items():
                ms[name] = (cs.cuda_ms(lambda: fused_mlp._forward_cuda(*a)),
                            cs.cuda_ms(lambda: fused_mlp.launch_backward(*a[:12], dout)))
            per = {k: sum(ms[n][i] * c for n, c in cs.EDGE_UPDATES.items()) for i, k in enumerate(("k2", "k2b"))}
            ok = fwd_err <= cs.K1_TOL and act_err <= cs.K1_TOL and bwd_err <= cs.K2B_TOL
            print(f"[{variant}] K2 per forward {per['k2']:.4f} ms | K2b per train step {per['k2b']:.4f} ms | "
                  + " | ".join(f"{n} {v[0]:.4f} / {v[1]:.4f}" for n, v in ms.items())
                  + f" | K2 err {fwd_err:.3e}, h0/h1 {act_err:.3e}, K2b err/max|g| {bwd_err:.3e} "
                  f"({'ok' if ok else 'FAILS'}) | ptxas "
                  + "; ".join(" ".join(libs[variant, s][1]) for s in SOURCES), flush=True)
        if args.readings:
            readings(cs, names, fused_mlp, c_function_of)
    finally:
        fused_mlp.c_function = own_c_function
    return 0


def readings(cs, names, fused_mlp, c_function_of) -> None:
    """chip_smoke.py phase 35 at the forecaster's initial weights, for each
    variant (see the module docstring)."""
    import graph_weather_tpu_torch as port

    lat_lons = cs.grid(1.0)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(1, len(lat_lons), cs.FEATURE_DIM + cs.AUX_DIM, generator=gen)
    y = torch.randn(1, len(lat_lons), cs.FEATURE_DIM, generator=gen)

    def grads(device, model, xx, yy):
        loss = port.NormalizedMSELoss(np.ones(cs.FEATURE_DIM), lat_lons, normalize=True, device=device)
        model.module.zero_grad(set_to_none=True)
        loss(model.forward_fn()(xx), yy).backward()
        return {k: t.grad.cpu() for k, t in model.module.named_parameters()}

    card = port.GraphWeatherForecaster(lat_lons, feature_dim=cs.FEATURE_DIM, aux_dim=cs.AUX_DIM,
                                       device="cuda")
    card.init(torch.Generator().manual_seed(0))
    cpu = port.GraphWeatherForecaster(lat_lons, feature_dim=cs.FEATURE_DIM, aux_dim=cs.AUX_DIM,
                                      device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in card.module.state_dict().items()})
    cpu_grads = grads("cpu", cpu, x, y)
    cs.forecaster_to_float64(cpu)
    exact = grads("cpu", cpu, x.double(), y.double())
    for variant in names:
        fused_mlp.c_function = c_function_of(variant)
        worst, name, outside = cs.grads_near_exact(grads("cuda", card, x.cuda(), y.cuda()), cpu_grads, exact)
        print(f"[{variant}] phase 35 at the initial weights: reading {worst:.4f} ({name}) | "
              + ", ".join(f"{k} ({r:.3f}, {q:.3f})" for k, r, q in outside), flush=True)


if __name__ == "__main__":
    sys.exit(main())
