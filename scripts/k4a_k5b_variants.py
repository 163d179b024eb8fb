"""What holds the banded attention forward K4a and the 3D NATTEN backward K5b
on an NVIDIA GPU: builds copies of csrc/banded_flash.cu and
csrc/natten_flash_bwd.cu with one change each and times them, K4a on the
real splits-5 band layout of GenCast's k-hop graph (21 blocks of 512 rows,
2,560-key windows; c = 128 and 512, 4 heads, per evaluation: 15 x c = 128 +
c = 512), K5b on the 128-d WeatherMesh's layer ([1, 14, 45, 90], 4 heads of
32, kernel (3, 5, 5), rpb; case a of chip_smoke.py phase 22) and at kernel
(5, 7, 7) with 8 heads (case c), each against its plain version.

    python3 scripts/k4a_k5b_variants.py [--out DIR] [--only NAME,NAME,...]

Variants:
  k4a              csrc/banded_flash.cu as it is: 16 x 16 warp tiles skipped
                   from one mask scan
  k4a_skip16x8     the same, and a warp tile's 8-key halves without an edge
                   skipped too (a branch per half, per warp)
  k4a_mid_cs2      c <= 128 on K4b's tile: 4 row groups of 2 warps (each over
                   64 channels), 32-key copied tiles
  k5b              csrc/natten_flash_bwd.cu as it is: four W-neighbouring
                   queries a group of ch/4 lanes in dq, two keys a group of
                   ch/8 lanes in dk/dv, the dk/dv kernel's inverse window
                   staged by D plane, drpb from per-axis slot tables
  k5b_no_wgroup    one query (key) a lane group of ch/16 lanes (16 channels
                   each) in both kernels: every row read serves one position
  k5b_dq_pair      two queries a group of ch/8 lanes in the dq kernel
  k5b_dkv_single   one key a group of ch/16 lanes in the dk/dv kernel, one
                   column at a time
  k5b_dkv_quad     four keys a group of ch/4 lanes in the dk/dv kernel
  k5b_dkv_nc1      one column at a time in the dk/dv kernel
  k5b_no_staging   the dk/dv kernel in its L1 mode (ry = 0, as for shapes
                   that cannot stage a row): its queries' q and dO rows, lse
                   and delta read through L1 once per pair
  k5b_old_drpb     the drpb partials summed as before: one thread per offset
                   over every query of the tile, the slot worked out per query
  k5b_nc1          one column at a time in both kernels (no independent
                   chains across columns)
  k5b_dq_nc2, k5b_dq_nc8  two or eight columns at a time in the dq kernel
  k5b_dkv_nc4      four columns at a time in the dk/dv kernel too, one CTA an
                   SM (at most 255 registers a thread)
  k5b_no_drpb      the dq kernel without its drpb partials (timed only)
  k5b_dq_copies_only  the dq kernel's staging, drpb and stores alone, no
                   products (timed only)
  k5b_dkv_copies_only the dk/dv kernel's staging and stores alone (timed only)

Each copy is built with nvcc into DIR (default graph_weather_tpu_torch/_build/
k4a_k5b_variants, beside the port's own builds); prints one line per variant:
its median times (CUDA events around batches of 5 launches; K5b's dq and
dk/dv kernels apart), its max abs error against the plain version, and
ptxas's registers and spills. f32; TF32 is off outside the kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "graph_weather_tpu_torch" / "csrc"

# -- K4a: skipping 8-key halves of a warp tile --------------------------------
HALVES = """using namespace ctile;

// Bit h: the CTA's row group has an edge in keys 8 h .. 8 h + 7 of the warp
// tile (the same for every warp of the row group).
__device__ __forceinline__ unsigned half_bits(const uint16_t* tile_bits, int lane) {
  const uint32_t row = tile_bits[lane & 15];
  return (__any_sync(0xffffffffu, (row & 0xffu) != 0) ? 1u : 0u) |
         (__any_sync(0xffffffffu, (row >> 8) != 0) ? 2u : 0u);
}

template <int KSTEPS>
__device__ __forceinline__ void row_products_halves(float (&acc)[2][4], const float* own,
                                                    const float* str, int ld, int k_begin,
                                                    int lane, unsigned halves) {
  float cross[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = cross[h][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int k0 = k_begin + 8 * kk;
    const FragA a = load_a(own, ld, k0, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!((halves >> h) & 1u)) continue;
      const FragB b = load_b_rows(str + 8 * h * ld, ld, k0, lane);
      mma_tf32(cross[h], a.small, b.big);
      mma_tf32(cross[h], a.big, b.small);
      mma_tf32(acc[h], a.big, b.big);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] += cross[h][e];
}

template <int NN>
__device__ __forceinline__ void add_col_products_halves(float (&acc)[NN][4], const float (&p)[2][4],
                                                        const float* str, int ld, int n_begin,
                                                        int lane, unsigned halves) {
  const FragA a[2] = {a_from_acc(p[0]), a_from_acc(p[1])};
  float part[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!((halves >> h) & 1u)) continue;
      const FragB b = load_b_cols(str + 8 * h * ld, ld, n_begin + 8 * n, lane);
      mma_tf32(part[n], a[h].small, b.big);
      mma_tf32(part[n], a[h].big, b.small);
      mma_tf32(part[n], a[h].big, b.big);
    }
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}
"""
ROW = "row_products16<CSW / 8>(s[j], q_rows, Ks + SUB * j * LD, LD, c_begin, lane);"
COL = "add_col_products<NN>(o, s[j], Vs + SUB * j * LD, LD, c_begin, lane);"
HB = "half_bits(tile_bits + 16 * j, lane)"
W128 = "using W128 = Cfg<128, 8, 1, 32>;"

# -- K5b ------------------------------------------------------------------------
CHUNKS = "constexpr int NC_DQ = 4, NC_DKV = 2;"
GROUPS = "constexpr int NQ_DQ = 4, CH_DQ = 4;\nconstexpr int NQ_DKV = 2, CH_DKV = 8;"
DKV_BOUNDS = "__launch_bounds__(256, 2) natten_dkv_kernel"
DKV_ROWS = "    for (int t = 0; t < n_rows; ++t) {"
DRPB_RETURN = "  if (p.rpb == nullptr || p.partial == nullptr) return;"
DQ_PRODUCTS = "    for (int y = 0; y < g.kh; ++y) {\n      const int row_h = (row_d"
DRPB_FROM = "  // drpb partials. Per axis, the slot"
DRPB_TO = "    p.partial[(((long long)blockIdx.z"
OLD_DRPB = """  // drpb partials: offset r sums ds over the tile's queries, in query order.
  const int tq = g.td * g.th * g.tw;
  for (int r = threadIdx.x; r < n_rel; r += blockDim.x) {
    const int rd = r / (nrh * nrw), rh = r / nrw % nrh, rw = r % nrw;
    float sum = 0.f;
    for (int q = 0; q < tq; ++q) {
      const int jd = d0 + q / (g.th * g.tw), jh = h0 + q / g.tw % g.th, jw = w0 + q % g.tw;
      if (jd >= g.d || jh >= g.h || jw >= g.w) continue;
      const int sx = slot_of(rd, jd, g.d, g.kd, false);
      const int sy = slot_of(rh, jh, g.h, g.kh, false);
      const int sz = slot_of(rw, jw, g.w, g.kw, g.circular_w);
      if (sx < 0 || sy < 0 || sz < 0) continue;
      sum += DSs[q * n_slots + (sx * g.kh + sy) * g.kw + sz];
    }
"""

# Variants whose dk/dv kernel the host runs with ry = 0 (its L1 mode).
UNSTAGED = {"k5b_no_staging"}
# name -> (source, edits); an edit (old, new) or a callable on the text
VARIANTS = {
    "k4a": ("banded_flash.cu", []),
    "k4a_skip16x8": ("banded_flash.cu", [("using namespace ctile;\n", HALVES),
                                         (ROW, ROW.replace("row_products16", "row_products_halves")
                                          .replace("lane);", f"lane, {HB});")),
                                         (COL, COL.replace("add_col_products", "add_col_products_halves")
                                          .replace("lane);", f"lane, {HB});"))]),
    "k4a_mid_cs2": ("banded_flash.cu", [(W128, "using W128 = Cfg<128, 4, 2, 32>;")]),
    "k5b": ("natten_flash_bwd.cu", []),
    "k5b_no_wgroup": ("natten_flash_bwd.cu", [(GROUPS, GROUPS.replace("4, CH_DQ = 4", "1, CH_DQ = 16")
                                                .replace("2, CH_DKV = 8", "1, CH_DKV = 16"))]),
    "k5b_dq_pair": ("natten_flash_bwd.cu", [(GROUPS, GROUPS.replace("4, CH_DQ = 4", "2, CH_DQ = 8"))]),
    "k5b_dkv_single": ("natten_flash_bwd.cu", [(GROUPS, GROUPS.replace("2, CH_DKV = 8", "1, CH_DKV = 16")),
                                               (CHUNKS, "constexpr int NC_DQ = 4, NC_DKV = 1;")]),
    "k5b_dkv_quad": ("natten_flash_bwd.cu", [(GROUPS, GROUPS.replace("2, CH_DKV = 8", "4, CH_DKV = 4"))]),
    "k5b_dkv_nc1": ("natten_flash_bwd.cu", [(CHUNKS, "constexpr int NC_DQ = 4, NC_DKV = 1;")]),
    "k5b_no_staging": ("natten_flash_bwd.cu", []),  # run with ry = 0: UNSTAGED
    "k5b_old_drpb": ("natten_flash_bwd.cu", [
        lambda t: t[:t.index(DRPB_FROM)] + OLD_DRPB + t[t.index(DRPB_TO):]]),
    "k5b_nc1": ("natten_flash_bwd.cu", [(CHUNKS, "constexpr int NC_DQ = 1, NC_DKV = 1;")]),
    "k5b_dq_nc2": ("natten_flash_bwd.cu", [(CHUNKS, "constexpr int NC_DQ = 2, NC_DKV = 2;")]),
    "k5b_dq_nc8": ("natten_flash_bwd.cu", [(CHUNKS, "constexpr int NC_DQ = 8, NC_DKV = 2;")]),
    "k5b_dkv_nc4": ("natten_flash_bwd.cu", [(CHUNKS, "constexpr int NC_DQ = 4, NC_DKV = 4;"),
                                            (DKV_BOUNDS, DKV_BOUNDS.replace("256, 2", "256, 1"))]),
    "k5b_no_drpb": ("natten_flash_bwd.cu", [(DRPB_RETURN, "  return;")]),
    "k5b_dq_copies_only": ("natten_flash_bwd.cu", [(DQ_PRODUCTS, DQ_PRODUCTS.replace("y < g.kh", "y < 0"))]),
    "k5b_dkv_copies_only": ("natten_flash_bwd.cu", [(DKV_ROWS, DKV_ROWS.replace("n_rows;", "0;"))]),
}


def nvcc_command(nvcc: str, src: Path, so: Path) -> list[str]:
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC), "-o", str(so), str(src)]


def build(out: Path, nvcc: str) -> dict:
    """Every variant's library, one nvcc each, all at once. Returns
    {variant: (path, ptxas report of the instantiations the runs use)}."""
    jobs = {}
    for name, (source, edits) in VARIANTS.items():
        text = (CSRC / source).read_text()
        for edit in edits:
            if callable(edit):
                text = edit(text)
                continue
            old, new = edit
            if old not in text:
                raise ValueError(f"variant {name}: {source} no longer holds {old!r}")
            text = text.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(text)
        jobs[name] = (d / source, d / "lib.so")
    procs = {k: subprocess.Popen(nvcc_command(nvcc, src, so), stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (src, so) in jobs.items()}
    libs = {}
    for key, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        report, current = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                current = line.split("'")[1] if "'" in line else line
            elif current and ("registers" in line or "spill" in line):
                report.setdefault(current, []).append(line.split(":", 1)[-1].strip())
        # K4a: <128, 8, 1, 32> and <512, 2, 4, 16>; K5b: <32>
        wanted = ("CfgILi128E", "CfgILi512E", "kernelILi32E")
        lines = [f"{k.split('kernel')[0][-12:]}..{' '.join(v)}" for k, v in report.items()
                 if any(w in k for w in wanted)]
        libs[key] = (jobs[key][1], lines)
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path,
                        default=ROOT / "graph_weather_tpu_torch" / "_build" / "k4a_k5b_variants")
    parser.add_argument("--only", default=None, help="comma-separated variant names")
    args = parser.parse_args()
    if args.only:
        keep = args.only.split(",")
        unknown = set(keep) - set(VARIANTS)
        if unknown:
            raise SystemExit(f"unknown variants: {sorted(unknown)}")
        for name in list(VARIANTS):
            if name not in keep:
                del VARIANTS[name]
    if not torch.cuda.is_available():
        print("k4a_k5b_variants: no CUDA device; this script times kernels on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from graph_weather_tpu_torch.models.gencast.graphs import build_graphcast_graphs
    from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
    from graph_weather_tpu_torch.ops import _build, banded_flash, natten_flash

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    libs = build(args.out, _build._nvcc())
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    # K4a on the splits-5 band layout.
    if any(n.startswith("k4a") for n in libs):
        gc = cs.GENCAST
        band = DeviceGraph.from_bundle(build_graphcast_graphs(
            gc["grid_lon"], gc["grid_lat"], splits=5, num_hops=4, add_edge_features_to_khop=False,
            spatial_sort=True,
        ).khop, "cuda", banded=True, band_flash=True)
        masks, block, w = band.band_masks, band.band_block, band.band_w
        per_eval = {128: gc["num_blocks"] - 1, 512: 1}
        k4a_inputs = {}
        for c in per_eval:
            _, (q, k, v) = cs.band_inputs(gen, band, c, 4, 3)
            k4a_inputs[c] = (q, k, v, banded_flash.banded_flash_forward_reference(q, k, v, masks, block, w))
        for name in (n for n in libs if n.startswith("k4a")):
            path, ptxas = libs[name]
            fn = ctypes.CDLL(str(path)).gwt_banded_flash_forward
            fn.argtypes, fn.restype = banded_flash._FWD_ARGTYPES, ctypes.c_int
            ms, err = {}, 0.0
            for c, (q, k, v, ref) in k4a_inputs.items():
                out = torch.empty_like(q)
                batch, n, heads, _, nb = banded_flash._sizes(q, masks)

                def run():
                    if fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), masks.data_ptr(), out.data_ptr(), 0,
                          batch, n, heads, c, nb, block, w, 1, c**-0.5, stream()):
                        raise RuntimeError(f"{name}: launch failed")

                run()
                torch.cuda.synchronize()
                err = max(err, (out - ref).abs().max().item())
                ms[c] = cs.cuda_ms(run)
            per = sum(ms[c] * m for c, m in per_eval.items())
            print(f"[k4a] {name:16s} ms_per_eval={per:.4f} (c=128 {ms[128]:.4f}, c=512 {ms[512]:.4f} per "
                  f"launch) max_abs_err {err:.2e} | " + " | ".join(ptxas), flush=True)
        del band, masks, k4a_inputs

    # K5b on the WeatherMesh layer (case a) and at (5, 7, 7) x 8 heads (case c).
    if any(n.startswith("k5b") for n in libs):
        cases = {"a": ((3, 5, 5), 4), "c": ((5, 7, 7), 8)}
        k5b_inputs = {}
        for case, (kernel, heads) in cases.items():
            q, k, v, rpb = cs.natten_inputs(gen, kernel, heads)
            dout = torch.randn(q.shape, generator=gen, device="cuda")
            out, lse = natten_flash._forward_cuda(q, k, v, kernel, rpb, False, with_lse=True)
            want = natten_flash.natten_flash_backward_reference(q, k, v, rpb, out, lse, dout, kernel, False)
            k5b_inputs[case] = (q, k, v, rpb, dout, lse, (dout * out).sum(-1).contiguous(), want)
        for name in (n for n in libs if n.startswith("k5b")):
            path, ptxas = libs[name]
            fn = ctypes.CDLL(str(path)).gwt_natten_flash_backward
            fn.argtypes, fn.restype = natten_flash._BWD_ARGTYPES, ctypes.c_int
            line = []
            for case, (kernel, heads) in cases.items():
                q, k, v, rpb, dout, lse, delta, want = k5b_inputs[case]
                dims, ch = tuple(q.shape[1:4]), q.shape[-1]
                grads = tuple(torch.zeros_like(q) for _ in range(3))
                dq_tile = natten_flash._pick_tile("dq", dims, kernel, False, ch, True)
                partial = torch.empty(dq_tile.n_tiles, heads, rpb[0].numel(), device="cuda")

                def launch(mode):
                    tile = dq_tile if mode == 0 else natten_flash._pick_tile("dkv", dims, kernel, False, ch, True)
                    geometry = natten_flash._geometry(q, k, v, kernel, False, tile, (q, k, v, dout, *grads))
                    ry = 0 if mode == 0 or name in UNSTAGED else natten_flash._dkv_rows(tile, kernel, ch)
                    outs = (grads[0], None, None, partial) if mode == 0 else (None, grads[1], grads[2], None)

                    def run():
                        if fn(mode, q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(),
                              dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                              *(natten_flash._ptr(t) for t in outs), *geometry[:-1], ry, stream()):
                            raise RuntimeError(f"{name}: launch failed")
                    return run

                dq_run, dkv_run = launch(0), launch(1)
                dq_run(), dkv_run()
                torch.cuda.synchronize()
                err = max((a - b).abs().max().item() for a, b in zip(grads, want[:3]))
                drpb = partial.sum(0).reshape(rpb.shape)
                err = max(err, ((drpb - want[3]).abs().max() / want[3].abs().max()).item())
                line.append(f"case {case}: dq_ms={cs.cuda_ms(dq_run):.4f} dkv_ms={cs.cuda_ms(dkv_run):.4f} "
                            f"max_err {err:.2e}")
            print(f"[k5b] {name:16s} " + " | ".join(line) + " | " + " | ".join(ptxas), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
