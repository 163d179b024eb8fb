"""What holds the 3D neighborhood attention forward K6 back on an NVIDIA GPU,
and which of its two designs is faster: builds copies of csrc/natten3d.cu
with one change each, and the other design (scripts/natten3d_mma.cu), and
times each on the 768-d WeatherMesh's layer ([1, 14, 45, 90], 8 heads of 96,
kernel (5, 7, 7), rpb), against the plain version's output.

    python3 scripts/natten3d_variants.py [--out DIR]

Variants (the tile plan of ops/natten3d.plan unless named):
  final         csrc/natten3d.cu as it is: register-tiled FP32, eight lanes
                to four W-neighbouring queries, 8 query rows x 16 columns a
                CTA, items of 5 of the union's 12 x 22 rows
  no_pv         without the p . v FMAs (timed only)
  no_products   without the q . k and p . v FMAs (timed only)
  no_copies     no_products without the K and V copies either (timed only)
  no_reduce_shfl  the reduce-scatter's shuffles replaced by the lane's own
                values (timed only)
  no_bcast_shfl   p . v with the lane's own p instead of the broadcast ones
                (timed only)
  two_ctas      __launch_bounds__(256, 2) (at most 128 registers a thread)
                and items of 3 rows, so that two CTAs share an SM
  rows4, rows2  CTAs of 4 (2) query rows, items of 3 (4) rows: two (three or
                more) CTAs share an SM at the registers final takes
  mma           the other design (scripts/natten3d_mma.cu): split-TF32
                mma.sync m16n8k8 products of a warp's 4 x 4 queries against
                its union of windows, 8 warps (8 x 16 queries) a CTA, items
                of 6 union rows, chunks of 8 key tiles
  mma_nt4, mma_nt2  the same with chunks of 4 or 2 key tiles (32 or 16 keys)
  mma_one_product   mma_nt2 with big . big only (TF32 accuracy; timed only)

Each copy is built with nvcc into DIR (default graph_weather_tpu_torch/_build/
natten3d_variants, beside the port's own builds); prints one line per variant:
its median time per layer (CUDA events around batches of 5 launches), its
max abs error against the plain version, and ptxas's registers and spills of
the instantiation the layer runs. f32; TF32 is off outside the kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
CSRC = ROOT / "graph_weather_tpu_torch" / "csrc"
SHAPE, KERNEL = (1, 14, 45, 90, 8, 96), (5, 7, 7)
PV = """            for (int c = 0; c < CL; ++c) o[j][c] = fmaf(pj, vv[c], o[j][c]);"""
QK = """              a = fmaf(qr[j][c], kv[c], a);
              b = fmaf(qr[j][c + 1], kv[c + 1], b);"""
FIRST_COPY = """  copy_item(0, 0);"""
COPY = """    if (it + 1 < n_items) copy_item(it + 1, (it + 1) & 1);"""
BOUNDS = "__launch_bounds__(256, 1)"
SH1, SH2, SH3 = ("__shfl_xor_sync(0xffffffffu, send, LANES / 2)",
                 "__shfl_xor_sync(0xffffffffu, send, LANES / 4)",
                 "__shfl_xor_sync(0xffffffffu, send, HALF)")
R1 = "s2[jj][u] = keep + " + SH1
R2 = "s1[u] = keep + " + SH2
R3 = "x5[u] = keep + " + SH3
BCAST = """            const float pj = __shfl_sync(0xffffffffu, x5[u % (NC / 2)], src);"""
# The mma design's chunk size and cross products.
MMA_LAUNCH = """    case 96 * 16 + 8: return launch<96, 8, false>(p, s);"""
MMA_CROSS = ["""          mma_tf32(s[nt], a.small, bf.big);
          mma_tf32(s[nt], a.big, bf.small);
""", """          mma_tf32(o[n], a.small, bf.big);
          mma_tf32(o[n], a.big, bf.small);
"""]


def mma_nt(nt):
    return (MMA_LAUNCH, MMA_LAUNCH.replace("96, 8,", f"96, {nt},"))


# name -> (source, edits, plan arguments after `scale` (None: ops/natten3d.plan's))
VARIANTS = {
    "final": ("natten3d.cu", [], None),
    "no_pv": ("natten3d.cu", [(PV, "            (void)pj;")], None),
    "no_products": ("natten3d.cu", [(PV, "            (void)pj;"), (QK, "              a += kv[c];")],
                    None),
    "no_copies": ("natten3d.cu", [(PV, "            (void)pj;"), (QK, "              a += kv[c];"),
                                  (FIRST_COPY, ""), (COPY, "")], None),
    "two_ctas": ("natten3d.cu", [(BOUNDS, "__launch_bounds__(256, 2)")], (96, 8, 8, 3, 22)),
    "rows4": ("natten3d.cu", [], (96, 8, 4, 3, 22)),
    "rows2": ("natten3d.cu", [], (96, 8, 2, 4, 22)),
    "no_reduce_shfl": ("natten3d.cu", [(R1, R1.replace(SH1, "send")), (R2, R2.replace(SH2, "send")),
                                       (R3, R3.replace(SH3, "send"))], None),
    "no_bcast_shfl": ("natten3d.cu", [(BCAST, "            const float pj = x5[u % (NC / 2)];")],
                      None),
    "mma": ("natten3d_mma.cu", [], (96, 8, 2, 4, 6, 22)),
    "mma_nt4": ("natten3d_mma.cu", [mma_nt(4)], (96, 8, 2, 4, 6, 22)),
    "mma_nt2": ("natten3d_mma.cu", [mma_nt(2)], (96, 8, 2, 4, 6, 22)),
    "mma_one_product": ("natten3d_mma.cu", [mma_nt(2)] + [(c, "") for c in MMA_CROSS],
                        (96, 8, 2, 4, 6, 22)),
}


def nvcc_command(nvcc: str, src: Path, so: Path) -> list[str]:
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC), "-o", str(so), str(src)]


def build(out: Path, nvcc: str) -> dict:
    """Every variant's library, one nvcc each, all at once. Returns
    {variant: (path, ptxas report of the instantiation at 96 channels)}."""
    jobs = {}
    for name, (source, edits, _) in VARIANTS.items():
        text = (CSRC / source if source == "natten3d.cu" else HERE / source).read_text()
        for old, new in edits:
            if old not in text:
                raise ValueError(f"variant {name}: {source} no longer holds {old!r}")
            text = text.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "natten3d.cu").write_text(text)
        jobs[name] = (d / "natten3d.cu", d / "natten3d.so")
    procs = {k: subprocess.Popen(nvcc_command(nvcc, src, so), stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (src, so) in jobs.items()}
    libs = {}
    for key, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        # ptxas reports each kernel after its "Compiling entry function" line.
        report, current = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                current = line.split("'")[1] if "'" in line else line
            elif current and ("registers" in line or "spill" in line):
                report.setdefault(current, []).append(line.split(":", 1)[-1].strip())
        wanted = ("ILi12ELi8E", "ILi96ELi")  # <12, 8> (final), <96, ...> (mma)
        lines = next((v for k, v in report.items() if any(w in k for w in wanted)), [])
        libs[key] = (jobs[key][1], lines)
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path,
                        default=ROOT / "graph_weather_tpu_torch" / "_build" / "natten3d_variants")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("natten3d_variants: no CUDA device; this script times kernels on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from graph_weather_tpu_torch.ops import _build, natten3d
    from graph_weather_tpu_torch.ops.natten_flash import _position_stride
    from graph_weather_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_3d_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    libs = build(args.out, _build._nvcc())
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, rpb = cs.natten_inputs(gen, KERNEL, SHAPE[4], SHAPE[5])
    ref = neighborhood_attention_3d_reference(q, k, v, KERNEL, rpb, False)
    b, d, h, w, heads, ch = q.shape
    strides = [_position_stride(t, "t") for t in (q, k, v)]
    shipped = natten3d.plan(SHAPE, KERNEL, False)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for name, (path, ptxas) in libs.items():
        tiles = VARIANTS[name][2] or (shipped.cp, shipped.lanes, shipped.rows, shipped.ry, shipped.rx)
        fn = ctypes.CDLL(str(path)).gwt_natten3d_forward
        fn.argtypes = natten3d._ARGTYPES[:-6] + [ctypes.c_int] * len(tiles) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = torch.zeros_like(q)

        def run():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(), out.data_ptr(), 0,
                     b, d, h, w, heads, ch, *strides, *KERNEL, 0, 1, ch**-0.5, *tiles, stream())
            if err:
                raise RuntimeError(f"{name}: launch failed ({err})")

        run()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ms = cs.cuda_ms(run)
        print(f"[k6] {name:16s} plan {tiles} ms_per_layer={ms:.4f} max_abs_err {err:.2e} | "
              + " | ".join(ptxas), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
