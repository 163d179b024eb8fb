"""What holds the 3D neighborhood attention forward K5a back on an NVIDIA GPU:
builds copies of csrc/natten_flash.cu with one change each, and the design
before it (scripts/natten_flash_halo.cu), and times each on chip_smoke.py
phase 18's cases a ([1, 14, 45, 90], 4 heads of 32, kernel (3, 5, 5)) and c
(8 heads of 32, kernel (5, 7, 7)), with rpb, against the plain version's
output; K6 (csrc/natten3d.cu) on the same shapes.

    python3 scripts/k5a_variants.py [--out DIR]

Variants (the plan of ops/natten_flash._fwd_plan unless named):
  final          csrc/natten_flash.cu as it is: four W-neighbouring queries a
                 group of 8 lanes (4 channels each), chunks of 8 (case a) and
                 10 (case c) columns, whole D-plane slabs in two stages, two
                 CTAs an SM; also with lse
  rows=TD,TH[/S] the CTA's eight warps as TD query planes by TH rows, items
                 of the slab's rows in S strips (default 1: whole slabs)
  nq2, nq1       groups of two and one W-neighbouring queries (NQ), the
                 same lanes (tiles of 8 and 4 columns)
  nc4            chunks of 4 columns at kw = 5 (two a key row; case a)
  nc6            chunks of 6 columns at kw = 7 (two a key row; case c)
  lanes4[/2]     groups of four lanes (8 channels each) at 32 channels: 32
                 query columns a warp; whole slabs (one CTA an SM by shared
                 memory) or halves (two)
  per_key        the online softmax's rescale once a key instead of once a
                 chunk (each key's alpha and p broadcast to the group)
  ctas1          __launch_bounds__(256, 1): one CTA an SM, up to 255
                 registers (the final plan's tiles)
  ctas3          __launch_bounds__(256, 3): three CTAs an SM at 80
                 registers, items of half a slab's rows to fit the shared
                 memory
  copy1, copy4   one (four) 16-byte copies of a staged row a thread, instead
                 of two (the address of a row computed once for them)
  halo           the design before this one (scripts/natten_flash_halo.cu):
                 the tile's whole 3D halo staged at once, four lanes a query,
                 one key at a time, the halo tile of _pick_tile("fwd")
  k6             K6 (csrc/natten3d.cu, ops/natten3d.py's plan), no lse
  no_pv          without the p . v FMAs (and so V's loads; timed only)
  no_products    no_pv without the q . k FMAs either (K's loads kept)
  no_copies      no_products without the K and V copies (timed only)
  no_reduce_shfl the reduce-scatter's shuffles replaced by the lane's own
                 values (timed only)
  no_bcast_shfl  p . v with the lane's own p instead of the broadcast ones
                 (timed only)

Each copy is built with nvcc into DIR (default graph_weather_tpu_torch/_build/
k5a_variants, beside the port's own builds), all at once; prints the card's
name and power limit, then one line per variant: its median time per launch
in each case (CUDA events around batches of 5 launches), its max abs error
against the plain version (out and, with lse, lse), and ptxas's registers and
spills of the instantiation case a runs. f32; TF32 is off.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
CSRC = ROOT / "graph_weather_tpu_torch" / "csrc"
CASES = {"a": ((3, 5, 5), 4), "c": ((5, 7, 7), 8)}  # kernel, heads (of 32 channels)
BOUNDS = ("launch<32, 4, NC_SHORT, 2>", "launch<32, 4, NC_LONG, 2>")
PER_KEY_FROM = "          const float m_new = fmaxf(m, cmax);\n"
PER_KEY_TO = "    __syncthreads();  // the stage is free for the copy two items on\n"
PER_KEY = """          // Per key: the query's columns in order on each of its lanes,
          // a rescale of the sum and of the accumulators for every key.
          float xs[NC];
          unsigned vall = valid;
#pragma unroll
          for (int u = 0; u < NCL; ++u) xs[u] = x[u];
          if constexpr (HALVE) {
            const unsigned vo = __shfl_xor_sync(0xffffffffu, valid, QL / 2);
#pragma unroll
            for (int u = 0; u < NCL; ++u) {
              const float xo = __shfl_xor_sync(0xffffffffu, x[u], QL / 2);
              xs[u] = my_u0 == 0 ? x[u] : xo;
              xs[NCL + u] = my_u0 == 0 ? xo : x[u];
            }
            vall = my_u0 == 0 ? valid | (vo << NCL) : vo | (valid << NCL);
          }
          float al[NC], pa[NC];
#pragma unroll
          for (int u = 0; u < NC; ++u) {
            const bool in = (vall >> u) & 1u;
            const float m_new = in ? fmaxf(m, xs[u]) : m;
            al[u] = exp2f(m - m_new);
            m = m_new;
            pa[u] = in ? exp2f(xs[u] - m) : 0.f;
            lsum = lsum * al[u] + pa[u];
          }
#pragma unroll
          for (int u = 0; u < NC; ++u) {
            const int cu = min(max(cs + u - c0, 0), ncols - 1);
            float vv[CL];
            load_slice<CL, LANES>(vv, v_row + cu * LD, l);
#pragma unroll
            for (int j = 0; j < NQ; ++j) {
              const float a = __shfl_sync(0xffffffffu, al[u], j * QL ^ qbits, LANES);
              const float pj = __shfl_sync(0xffffffffu, pa[u], j * QL ^ qbits, LANES);
#pragma unroll
              for (int c = 0; c < CL; ++c) o[j][c] = fmaf(pj, vv[c], o[j][c] * a);
            }
          }
        }
      }
    }
"""
LSUM_HALVES = "  if constexpr (HALVE) lsum += __shfl_xor_sync(0xffffffffu, lsum, QL / 2);\n"


LANES4 = ("    case (32 * 32 + 8) * 16 + NC_LONG: return launch<32, 4, NC_LONG, 2>(p, s);\n",
          "    case (32 * 32 + 8) * 16 + NC_LONG: return launch<32, 4, NC_LONG, 2>(p, s);\n"
          "    case (32 * 32 + 4) * 16 + NC_SHORT: return launch<32, 8, NC_SHORT, 2>(p, s);\n"
          "    case (32 * 32 + 4) * 16 + NC_LONG: return launch<32, 8, NC_LONG, 2>(p, s);\n")


PV = "              for (int c = 0; c < CL; ++c) o[j][c] = fmaf(pj, vv[c], o[j][c]);"
QK = "              for (int c = 0; c < CL; ++c) a = fmaf(qr[j][c], kv[c], a);"
NO_PV = (PV, "              (void)pj;")
NO_QK = (QK, "              for (int c = 0; c < CL; ++c) a += kv[c];")
NO_COPIES = [("  copy_item(0, 0);", ""), ("    if (it + 1 < n_items) copy_item(it + 1, (it + 1) & 1);", "")]
NO_REDUCE = [("s[jj][u] += __shfl_xor_sync(0xffffffffu, s[jj + half][u], bit);", "s[jj][u] += s[jj + half][u];"),
             ("x[u] = keep + __shfl_xor_sync(0xffffffffu, send, QL / 2);", "x[u] = keep + send;")]
NO_BCAST = [("__shfl_sync(0xffffffffu, x[u % NCL], (j * QL ^ qbits) + u / NCL * (QL / 2), LANES)",
             "x[u % NCL]")]


def bounds(minb):
    return [(b, b.replace(", 2>", f", {minb}>")) for b in BOUNDS]


# name -> (source, edits, plan changes {"td", "th", "strips", "nc": {case: nc}}, with lse)
VARIANTS = {
    "final": ("natten_flash.cu", [], {}, False),
    "final_lse": ("natten_flash.cu", [], {}, True),
    "rows=1,8": ("natten_flash.cu", [], {"td": 1, "th": 8}, False),
    "rows=1,8/2": ("natten_flash.cu", [], {"td": 1, "th": 8, "strips": 2}, False),
    "rows=2,4": ("natten_flash.cu", [], {"td": 2, "th": 4}, False),
    "rows=2,4/2": ("natten_flash.cu", [], {"td": 2, "th": 4, "strips": 2}, False),
    "rows=4,2": ("natten_flash.cu", [], {"td": 4, "th": 2}, False),
    "rows=8,1": ("natten_flash.cu", [], {"td": 8, "th": 1}, False),
    "nq2": ("natten_flash.cu", [("constexpr int NQ = 4;", "constexpr int NQ = 2;")], {}, False),
    "nq1": ("natten_flash.cu", [("constexpr int NQ = 4;", "constexpr int NQ = 1;")], {}, False),
    "nc4": ("natten_flash.cu", [("constexpr int NC_SHORT = 8;", "constexpr int NC_SHORT = 4;")],
            {"nc": {"a": 4}}, False),
    "nc6": ("natten_flash.cu", [("constexpr int NC_LONG = 10;", "constexpr int NC_LONG = 6;")],
            {"nc": {"c": 6}}, False),
    "per_key": ("natten_flash.cu", [(None, None), (LSUM_HALVES, "")], {}, False),
    "lanes4": ("natten_flash.cu", [LANES4], {"lanes": 4}, False),
    "lanes4/2": ("natten_flash.cu", [LANES4], {"lanes": 4, "strips": 2}, False),
    "ctas1": ("natten_flash.cu", bounds(1), {}, False),
    "ctas3": ("natten_flash.cu", bounds(3), {"strips": 2}, False),
    "copy1": ("natten_flash.cu", [("constexpr int COPY_F4 = 2;", "constexpr int COPY_F4 = 1;")], {}, False),
    "copy4": ("natten_flash.cu", [("constexpr int COPY_F4 = 2;", "constexpr int COPY_F4 = 4;")], {}, False),
    "halo": ("natten_flash_halo.cu", [], {}, False),
    "no_pv": ("natten_flash.cu", [NO_PV], {}, False),
    "no_products": ("natten_flash.cu", [NO_PV, NO_QK], {}, False),
    "no_copies": ("natten_flash.cu", [NO_PV, NO_QK] + NO_COPIES, {}, False),
    "no_reduce_shfl": ("natten_flash.cu", NO_REDUCE, {}, False),
    "no_bcast_shfl": ("natten_flash.cu", NO_BCAST, {}, False),
}


def nvcc_command(nvcc: str, src: Path, so: Path) -> list[str]:
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC), "-o", str(so), str(src)]


def edited(name: str) -> str:
    source, edits, _, _ = VARIANTS[name]
    text = (CSRC / source if source == "natten_flash.cu" else HERE / source).read_text()
    for old, new in edits:
        if old is None:  # the per-key block
            start, end = text.index(PER_KEY_FROM), text.index(PER_KEY_TO)
            text = text[:start] + PER_KEY + text[end:]
            continue
        if old not in text:
            raise ValueError(f"variant {name}: {source} no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build(out: Path, nvcc: str) -> dict:
    """Every distinct source's library, one nvcc each, all at once. Returns
    {variant: (path, ptxas report of case a's instantiation)}."""
    texts = {name: edited(name) for name in VARIANTS}
    jobs = {}
    for name, text in texts.items():
        first = next(n for n, t in texts.items() if t == text)
        d = out / first.replace("=", "_").replace(",", "_").replace("/", "_")
        if first == name:
            d.mkdir(parents=True, exist_ok=True)
            (d / "natten_flash.cu").write_text(text)
        jobs[name] = (d / "natten_flash.cu", d / "natten_flash.so", first)
    procs = {name: subprocess.Popen(nvcc_command(nvcc, src, so), stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, (src, so, first) in jobs.items() if first == name}
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{logs[name]}")
    libs = {}
    for name, (_, so, first) in jobs.items():
        # ptxas reports each kernel after its "Compiling entry function" line.
        report, current = {}, None
        for line in logs[first].splitlines():
            if "Compiling entry function" in line:
                current = line.split("'")[1] if "'" in line else line
            elif current and ("registers" in line or "spill" in line):
                report.setdefault(current, []).append(line.split(":", 1)[-1].strip())
        lines = []  # the instantiations at 32 channels: <32, CL, NC, MINB>; the halo design's <32, 512>
        for kernel, found in report.items():
            args = re.search(r"ILi32ELi(\d+)ELi(\d+)ELi\d+E", kernel)
            if args or "ILi32ELi512E" in kernel:
                lines.append((f"cl {args.group(1)} nc {args.group(2)}: " if args else "") + ", ".join(found))
        libs[name] = (so, lines)
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path,
                        default=ROOT / "graph_weather_tpu_torch" / "_build" / "k5a_variants")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k5a_variants: no CUDA device; this script times kernels on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from graph_weather_tpu_torch.ops import _build, natten3d, natten_flash as nf
    from graph_weather_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_3d_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    libs = build(args.out, _build._nvcc())
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for case, (kernel, heads) in CASES.items():
        q, k, v, rpb = cs.natten_inputs(gen, kernel, heads)
        inputs[case] = (q, k, v, rpb, *neighborhood_attention_3d_reference(
            q, k, v, kernel, rpb, False, with_lse=True))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def launcher(name, path, case):
        kernel = CASES[case][0]
        q, k, v, rpb, _, _ = inputs[case]
        out = torch.zeros_like(q)
        lse = torch.zeros(q.shape[:-1], device="cuda") if VARIANTS[name][3] else None
        lib = ctypes.CDLL(str(path))
        fn = lib.gwt_natten_flash_forward
        fn.restype = ctypes.c_int
        if name == "halo":
            tile = nf._pick_tile("fwd", cs.WM_LATENT, kernel, False, 32, True)
            fn.argtypes = [ctypes.c_void_p] * 6 + nf._GEOMETRY
            args = nf._geometry(q, k, v, kernel, False, tile, (q, k, v, out))[:-1]
            plan = (tile.td, tile.th, tile.tw)
        else:
            fn.argtypes = nf._FWD_ARGTYPES
            p = nf._fwd_plan(cs.WM_LATENT, kernel, False, 32, True)
            change = VARIANTS[name][2]
            td, th = change.get("td", p.td), change.get("th", p.th)
            uh = nf._max_span(cs.WM_LATENT[1], kernel[1], th, False, False)
            ry = -(-uh // change.get("strips", 1)) if ("th" in change or "strips" in change) else p.ry
            layout, vec4 = nf._layout(q, k, v, kernel, False, (q, k, v, out))
            nc = change.get("nc", {}).get(case, p.nc)
            lanes = change.get("lanes", p.lanes)
            rx = p.rx
            if "lanes" in change:  # the union of wider tiles
                rx = nf._max_span(cs.WM_LATENT[2], kernel[2], nf.FWD_NQ * 32 // lanes, False, False)
            args = (*layout, vec4, 32**-0.5, p.cp, lanes, nc, td, th, ry, rx)
            plan = (td, th, ry, rx)

        def run():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(), out.data_ptr(),
                     nf._ptr(lse), *args, stream())
            if err:
                raise RuntimeError(f"{name}: launch failed ({err})")
        return run, out, lse, plan

    for name, (path, ptxas) in libs.items():
        line = [f"[k5a] {name:11s}"]
        for case in CASES:
            run, out, lse, plan = launcher(name, path, case)
            run()
            torch.cuda.synchronize()
            _, _, _, _, ref, ref_lse = inputs[case]
            err = (out - ref).abs().max().item()
            if lse is not None:
                err = max(err, (lse - ref_lse).abs().max().item())
            line.append(f"{case}: plan {plan} ms={cs.cuda_ms(run):.4f} err {err:.2e}")
        print(" | ".join(line + ptxas), flush=True)
    line = ["[k5a] k6         "]
    for case, (kernel, _) in CASES.items():
        q, k, v, rpb, ref, _ = inputs[case]
        err = (natten3d._forward_cuda(q, k, v, kernel, rpb, False)[0] - ref).abs().max().item()
        ms = cs.cuda_ms(lambda: natten3d._forward_cuda(q, k, v, kernel, rpb, False))
        line.append(f"{case}: plan {natten3d.plan(tuple(q.shape), kernel, False)} ms={ms:.4f} "
                    f"err {err:.2e}")
    print(" | ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
