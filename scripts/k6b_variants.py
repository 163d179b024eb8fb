"""What holds the wide-head NATTEN backward K6b back on an NVIDIA GPU: builds
copies of csrc/natten3d_bwd.cu with one change each and times both of its
kernels, the dq kernel (which writes the slot table of p and ds) and the
dk/dv kernel (which reads it), on chip_smoke.py phase 41's cases, with rpb:
(a) the 768-d WeatherMesh's layer, [1, 14, 45, 90] x 8 heads of 96 at
kernel (5, 7, 7); (d) 2 x 256 at (3, 5, 5); (e) 2 x 128 at (5, 7, 7); (f)
4 x 64 at (3, 5, 5); each variant's dq, dk, dv and drpb against the plain
backward (natten_flash_backward_reference) on K6's out and lse.

    python3 scripts/k6b_variants.py [--out DIR] [--cases adef] [--only final,nk2,...]

Variants (the plans of ops/natten3d.plan_backward unless named):
  final          csrc/natten3d_bwd.cu as it is: the table query-major; NK
                 keys a dk/dv group and DKV_CTAS CTAs an SM; each staged
                 query's slots of the key plane copied with its q and dO
                 rows; (0, 0) for the keys outside a query's window (no
                 branch); the loop over a row's query columns unrolled twice
  branch         a branch past each key outside the query's window instead
  no_unroll      the loop over query columns not unrolled
  ctas1, ctas3   one CTA an SM (up to 255 registers), or three (80)
  nk4, nk4_ctas1, nk8_ctas1
                 NK = 4 keys a group (tiles of 16 columns at 8 lanes) at
                 DKV_CTAS CTAs an SM or at one; NK = 8 at one
  rows16         sixteen key rows a CTA (512 threads, one CTA an SM)
  l1             no slots staged: each pair's (p, ds) read from the table
                 through L1 (every lane of a group the same 8 bytes)
  l1_slot_major  l1 with the table slot-major, [B, heads, kd, slots, D, H,
                 W]: a slot's queries contiguous
  stcs           the dq kernel's table stores as streaming stores (__stcs:
                 evict first)
  no_writes      the dq kernel without its table stores (timed only)
  no_reads       the dk/dv kernel with (1, 1) for every pair's (p, ds), no
                 slots staged (timed only)
  no_fmas        the dk/dv kernel's dk and dv FMAs replaced by a sum of the
                 pair's (p, ds) (the staged slots kept; the compiler drops
                 the q and dO loads with the FMAs; timed only)

Each copy is built with nvcc into DIR (default graph_weather_tpu_torch/_build/
k6b_variants, beside the port's own builds), all at once; prints the card's
name and power limit, then one line per variant and case: each kernel's
median time per launch (CUDA events around batches of 5 launches), the
largest error of dq, dk, dv and drpb against the plain backward as a share of
that tensor's max|g|, the plans, and ptxas's registers and spills of the
case's instantiations. f32; TF32 is off.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "graph_weather_tpu_torch" / "csrc"
# name: kernel, heads, ch (chip_smoke.py phase 41's cases a, d, e and f)
CASES = {"a": ((5, 7, 7), 8, 96), "d": ((3, 5, 5), 2, 256), "e": ((5, 7, 7), 2, 128),
         "f": ((3, 5, 5), 4, 64)}
NK = "constexpr int NK = 2;"
CTAS = "constexpr int DKV_CTAS = 2;"
TABLE_AT = ("  return ((((long long)b * g.d * g.h * g.w + pos) * g.heads + head) * g.kd + x) * "
            "slab_slots(g) + s;")
SLOT_MAJOR = ("  return ((((long long)b * g.heads + head) * g.kd + x) * slab_slots(g) + s) * "
              "((long long)g.d * g.h * g.w) + pos;")
PICK = "          pds[j] = z >= 0 && z < g.kw ? tq[z] : make_float2(0.f, 0.f);"
FMAS = ("        for (int j = 0; j < NK; ++j) axpy<CL>(pds[j].x, xv, dv[j]);",
        "        for (int j = 0; j < NK; ++j) axpy<CL>(pds[j].y, xv, dk[j]);")
WRITE = ("          if (writes && in)\n"
         "            p.table[table_at(g, blockIdx.z, my_in, head, x, slot_row + cu)] =\n"
         "                make_float2(pr, ds[u]);\n")
COPY_SLOTS = (
    "    // Each position's slots of this key plane in its window, 16 bytes a copy.\n"
    "    float* ts = qs + 2 * item_pos * LD;\n"
    "    const int slab = jd - window_start(pd0 + x, g.d, g.kd);\n"
    "    const int per_pos = sp / 2;\n"
    "    const float inv_per = 1.f / per_pos;\n"
    "    for (int i = tid; i < n_pos * per_pos; i += threads) {\n"
    "      const int r = div_small(i, inv_per), c = i - r * per_pos;\n"
    "      cp_async16(ts + 2 * (r * sp + 2 * c),\n"
    "                 reinterpret_cast<const float*>(p.table + table_at(g, blockIdx.z, pos(r), head,\n"
    "                                                                   slab, 2 * c)),\n"
    "                 true);\n"
    "    }\n")
STAGE = "  const int stage_floats = item_pos * (2 * LD + 2 * sp);"
SMEM = "  return sizeof(float) * 2 * (size_t)p.ry * p.rx * (2 * (cp + 4) + 2 * slab_slots(p.g));"
UNSTAGED = [(COPY_SLOTS, ""), (STAGE, "  const int stage_floats = item_pos * 2 * LD;"),
            (SMEM, "  return sizeof(float) * 2 * (size_t)p.ry * p.rx * 2 * (cp + 4);")]
# l1: each pair's (p, ds) from the table through L1, at the query's position
L1 = UNSTAGED + [(PICK, "          pds[j] = z >= 0 && z < g.kw ? __ldg(p.table + table_at(\n"
                        "              g, blockIdx.z, ((long long)(pd0 + x) * g.h + y) * g.w + wrap_w(g, cu), head,\n"
                        "              jd - window_start(pd0 + x, g.d, g.kd), slot_row + z)) : make_float2(0.f, 0.f);")]

UNROLL = ("#pragma unroll 2\n      for (int cu = ca; cu < cb; ++cu) {", "      for (int cu = ca; cu < cb; ++cu) {")
# sixteen key rows a CTA, one warp each (512 threads, at most 128 registers)
ROWS16 = [("__global__ void __launch_bounds__(256, DKV_CTAS) natten3d_dkv_kernel",
           "__global__ void __launch_bounds__(512, 1) natten3d_dkv_kernel"),
          ("rows < 1 || rows > 8 ||", "rows < 1 || rows > 16 ||")]

# name -> (edits, dk/dv plan changes {"nk", "ctas", "rows", "unstaged"})
VARIANTS = {
    "final": ([], {}),
    "branch": ([(PICK, "          if (z < 0 || z >= g.kw) { pds[j] = make_float2(0.f, 0.f); continue; }\n"
                       "          pds[j] = tq[z];"),
                (FMAS[0], "        for (int j = 0; j < NK; ++j)\n"
                          "          if (kw_[j] - sw >= 0 && kw_[j] - sw < g.kw) axpy<CL>(pds[j].x, xv, dv[j]);"),
                (FMAS[1], "        for (int j = 0; j < NK; ++j)\n"
                          "          if (kw_[j] - sw >= 0 && kw_[j] - sw < g.kw) axpy<CL>(pds[j].y, xv, dk[j]);")],
               {}),
    "no_unroll": ([UNROLL], {}),
    "ctas1": ([(CTAS, "constexpr int DKV_CTAS = 1;")], {"ctas": 1}),
    "ctas3": ([(CTAS, "constexpr int DKV_CTAS = 3;")], {"ctas": 3}),
    "nk4": ([(NK, "constexpr int NK = 4;")], {"nk": 4}),
    "nk4_ctas1": ([(NK, "constexpr int NK = 4;"), (CTAS, "constexpr int DKV_CTAS = 1;")],
                  {"nk": 4, "ctas": 1}),
    "nk8_ctas1": ([(NK, "constexpr int NK = 8;"), (CTAS, "constexpr int DKV_CTAS = 1;")],
                  {"nk": 8, "ctas": 1}),
    "rows16": (ROWS16, {"rows": 16, "ctas": 1}),
    "l1": (L1, {"unstaged": True}),
    "l1_slot_major": (L1 + [(TABLE_AT, SLOT_MAJOR)], {"unstaged": True}),
    "stcs": ([(WRITE, "          if (writes && in)\n"
                      "            __stcs(p.table + table_at(g, blockIdx.z, my_in, head, x, slot_row + cu),\n"
                      "                   make_float2(pr, ds[u]));\n")], {}),
    "no_writes": ([(WRITE, "")], {}),
    "no_reads": (UNSTAGED + [(PICK, "          pds[j] = make_float2(1.f, 1.f); (void)z; (void)tq;")],
                 {"unstaged": True}),
    "no_fmas": ([(FMAS[0], "        for (int j = 0; j < NK; ++j) dv[j][0] += pds[j].x;"),
                 (FMAS[1], "        for (int j = 0; j < NK; ++j) dk[j][0] += pds[j].y;")], {}),
}
TIMED_ONLY = ("no_writes", "no_reads", "no_fmas")


def nvcc_command(nvcc: str, src: Path, so: Path) -> list[str]:
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC), "-o", str(so), str(src)]


def edited(name: str) -> str:
    text = (CSRC / "natten3d_bwd.cu").read_text()
    for old, new in VARIANTS[name][0]:
        if old not in text:
            raise ValueError(f"variant {name}: natten3d_bwd.cu no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build(out: Path, nvcc: str, names) -> dict:
    """The variants' libraries, one nvcc each, all at once. Returns {variant:
    (path, {(cl, lanes): ptxas lines of its dq and dk/dv kernels})}."""
    procs = {}
    for name in names:
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "natten3d_bwd.cu").write_text(edited(name))
        procs[name] = subprocess.Popen(nvcc_command(nvcc, d / "natten3d_bwd.cu", d / "lib.so"),
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        report, current = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"natten3d_(dq|dkv)_kernelILi(\d+)ELi(\d+)E", line)
                current = (m.group(1), int(m.group(2)), int(m.group(3))) if m else None
            elif current and ("registers" in line or "spill" in line):
                report.setdefault(current, []).append(line.split(":", 1)[-1].strip())
        libs[name] = (out / name / "lib.so", report)
    return libs


def dkv_plan(natten3d, shape, kernel, change):
    """The dk/dv kernel's plan with NK keys a group, CTAS CTAs an SM's shared
    memory and, unless unstaged, each position's slots of the key plane:
    plan_backward's rule with those changed."""
    from graph_weather_tpu_torch.ops.natten_flash import SMEM_LIMIT, _max_span

    base = natten3d.plan_backward(shape, kernel, False, True)[natten3d.DKV]
    _, d, h, w, _, _ = shape
    nk, ctas = change.get("nk", natten3d.BWD_NK), change.get("ctas", natten3d.BWD_DKV_CTAS)
    columns, rows = nk * 32 // base.lanes, min(change.get("rows", base.rows), h)
    cu_h = _max_span(h, kernel[1], rows, False, True)
    cu_w = _max_span(w, kernel[2], columns, False, True)
    slots = 0 if change.get("unstaged") else natten3d.table_shape(shape, kernel)[-2]
    position = 2 * 4 * (2 * (base.cp + 4) + 2 * slots)
    most = min(SMEM_LIMIT, natten3d.SM_SMEM // ctas - 1024) // position
    rx = natten3d._strips(cu_w, most)
    ry = natten3d._strips(cu_h, most // rx)
    return dataclasses.replace(base, rows=rows, columns=columns, ry=ry, rx=rx,
                               smem=position * ry * rx, n_tiles=d * -(-h // rows) * -(-w // columns))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path,
                        default=ROOT / "graph_weather_tpu_torch" / "_build" / "k6b_variants")
    parser.add_argument("--cases", default="".join(CASES))
    parser.add_argument("--only", default=None, help="comma-separated variants (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k6b_variants: no CUDA device; this script times kernels on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from graph_weather_tpu_torch.ops import _build, natten3d, natten_flash
    from graph_weather_tpu_torch.ops.natten_flash import _ptr

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    libs = build(args.out, _build._nvcc(), args.only.split(",") if args.only else list(VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for case in args.cases:
        kernel, heads, ch = CASES[case]
        q, k, v, rpb = cs.natten_inputs(gen, kernel, heads, ch)
        dout = torch.randn(q.shape, generator=gen, device="cuda")
        out, lse = natten3d._forward_cuda(q, k, v, kernel, rpb, False, with_lse=True)
        want = natten_flash.natten_flash_backward_reference(q, k, v, rpb, out, lse, dout, kernel, False)
        shape = tuple(q.shape)
        table = torch.empty(natten3d.table_shape(shape, kernel), device="cuda")
        layout = natten3d._layout(q, k, v, kernel, False, (q, k, v, dout))
        dq_plan = natten3d.plan_backward(shape, kernel, False, True)[natten3d.DQ]
        cl = dq_plan.cp // dq_plan.lanes
        for name, (path, ptxas) in libs.items():
            fn = ctypes.CDLL(str(path)).gwt_natten3d_backward
            fn.restype, fn.argtypes = ctypes.c_int, natten3d._BWD_ARGTYPES
            plan = {natten3d.DQ: dq_plan, natten3d.DKV: dkv_plan(natten3d, shape, kernel, VARIANTS[name][1])}
            grads = tuple(torch.zeros_like(q) for _ in range(3))
            partial = torch.zeros(dq_plan.n_tiles, heads, rpb[0].numel(), device="cuda")

            def launch(mode, fn=fn, plan=plan, grads=grads, partial=partial):
                outs = (grads[0], None, None, partial) if mode == natten3d.DQ else (None, *grads[1:], None)
                t = plan[mode]
                err = fn(mode, q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(), dout.data_ptr(),
                         lse.data_ptr(), out.data_ptr(), *(_ptr(x) for x in outs), table.data_ptr(),
                         *layout, t.cp, t.lanes, t.rows, t.ry, t.rx, stream())
                if err:
                    raise RuntimeError(f"{name}: launch of mode {mode} failed ({err})")

            launch(natten3d.DQ)
            launch(natten3d.DKV)
            torch.cuda.synchronize()
            got = (*grads, partial.sum(0).reshape(rpb.shape))
            errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want)]
            dq_ms = cs.cuda_ms(lambda: launch(natten3d.DQ))
            dkv_ms = cs.cuda_ms(lambda: launch(natten3d.DKV))
            regs = [f"{kind} " + ", ".join(lines) for (kind, c, lanes), lines in sorted(ptxas.items())
                    if (c, lanes) == (cl, dq_plan.lanes)]
            verdict = "timed only" if name in TIMED_ONLY else (
                "ok" if max(errs) <= cs.K5_TOL else "FAILS 1e-4")
            print(f"[k6b] {name:10s} {case}: dq_ms={dq_ms:.4f} dkv_ms={dkv_ms:.4f} sum={dq_ms + dkv_ms:.4f} | "
                  f"error / max|g| dq {errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e} drpb {errs[3]:.2e} "
                  f"({verdict}) | dk/dv plan columns {plan[natten3d.DKV].columns} ry {plan[natten3d.DKV].ry} "
                  f"rx {plan[natten3d.DKV].rx} smem {plan[natten3d.DKV].smem} | " + " | ".join(regs),
                  flush=True)
            del grads, partial
        del q, k, v, rpb, dout, out, lse, want, table
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
