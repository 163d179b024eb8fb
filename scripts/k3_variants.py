"""What holds the clustered attention kernels K3a and K3c back on an NVIDIA
GPU: builds copies of csrc/clustered_tile.cuh, clustered_flash.cu and
clustered_flash_bwd.cu with one change each, and times the forward (with
lse) and the symmetric backward's two kernels on GenCast's splits-5 layout
at c = 128 and 512, against the plain versions' outputs. Also measures what
mma.sync m16n8k8 with TF32 inputs delivers on the card, alone.

    python3 scripts/k3_variants.py [--out DIR]

Variants:
  final        the sources as they are
  cvt_split    the TF32 split by cvt.rna.tf32.f32 instead of integer rounding
  one_product  big . big only (no cross terms: TF32 accuracy; timed only)
  no_pv        the forward without its p.v products (timed only)
  no_products  the forward without either product (timed only)
  no_softmax   no_products without the online softmax either (timed only)
  no_copies    no_products without the K and V copies (timed only)
  two_ctas     __launch_bounds__(256, 2) in both files: at most 128
               registers a thread, two CTAs per SM where shared memory allows

Each copy is built with nvcc into DIR (default graph_weather_tpu_torch/_build/
k3_variants, beside the port's own builds);
prints one line per variant and width. f32; TF32 is off outside the kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "graph_weather_tpu_torch" / "csrc"
SOURCES = ("clustered_tile.cuh", "clustered_flash.cu", "clustered_flash_bwd.cu")
CROSS_ROW = """      mma_tf32(cross[h], a.small, b.big);
      mma_tf32(cross[h], a.big, b.small);
"""
CROSS_COL = """    mma_tf32(acc[n], a0.small, b0.big);
    mma_tf32(acc[n], a0.big, b0.small);
    mma_tf32(acc[n], a1.small, b1.big);
    mma_tf32(acc[n], a1.big, b1.small);
"""
PV = """          col_products16<NN>(o, s[j], Vs + SUB * j * LD, LD, c_begin, lane);"""
S = """        row_products16<CSW / 8>(s[j], q_rows, Ks + SUB * j * LD, LD, c_begin, lane);"""
BOUNDS = "__launch_bounds__(C::THREADS, 1)"
SOFTMAX = """    if (act) {
      // Online softmax"""
COPY = """    if (i + STAGES - 1 < n_list) copy_tile("""
FIRST_COPY = """    if (t < n_list) copy_tile(t, s_tiles[t]);"""
RNA = """  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"""
CVT = """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;"""
# name -> {source: [(text, replacement), ...]}
VARIANTS = {
    "final": {},
    "cvt_split": {"clustered_tile.cuh": [(RNA, CVT)]},
    "one_product": {"clustered_tile.cuh": [(CROSS_ROW, ""), (CROSS_COL, "")]},
    "no_pv": {"clustered_flash.cu": [(PV, "          ;")]},
    "no_products": {"clustered_flash.cu": [(PV, "          ;"), (S, "        s[j][0][0] = 0.f;")]},
    "no_softmax": {"clustered_flash.cu": [(PV, "          ;"), (S, "        s[j][0][0] = 0.f;"),
                                          (SOFTMAX, SOFTMAX.replace("(act)", "(false)"))]},
    "no_copies": {"clustered_flash.cu": [(PV, "          ;"), (S, "        s[j][0][0] = 0.f;"),
                                         (COPY, COPY.replace("i + STAGES - 1 < n_list", "false")),
                                         (FIRST_COPY, FIRST_COPY.replace("t < n_list", "false"))]},
    "two_ctas": {src: [(BOUNDS, BOUNDS.replace(", 1)", ", 2)"))]
                 for src in ("clustered_flash.cu", "clustered_flash_bwd.cu")},
}
MMA_RATE = r"""
#include <cuda_runtime.h>
#include <cstdint>
template <int CHAINS>
__global__ void __launch_bounds__(256) mma_loop(float* out, int iters) {
  float acc[CHAINS][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i);
  b[0] = a[1];
  b[1] = a[2];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate(float* out, int chains, int blocks, int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chains == 1) mma_loop<1><<<blocks, 256, 0, s>>>(out, iters);
  if (chains == 2) mma_loop<2><<<blocks, 256, 0, s>>>(out, iters);
  if (chains == 4) mma_loop<4><<<blocks, 256, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def nvcc_command(nvcc: str, src: Path, so: Path) -> list[str]:
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(so), str(src)]


def build(out: Path, nvcc: str) -> dict:
    """Every variant's two libraries and the mma probe, one nvcc each, all at
    once. Returns {(variant, library): path}."""
    jobs = {}
    for name, edits in VARIANTS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for src in SOURCES:
            text = (CSRC / src).read_text()
            for old, new in edits.get(src, []):
                if old not in text:
                    raise ValueError(f"variant {name}: {src} no longer holds {old!r}")
                text = text.replace(old, new)
            (d / src).write_text(text)
        for lib in ("clustered_flash", "clustered_flash_bwd"):
            jobs[(name, lib)] = (d / f"{lib}.cu", d / f"{lib}.so")
    (out / "mma_rate.cu").write_text(MMA_RATE)
    jobs[("probe", "mma_rate")] = (out / "mma_rate.cu", out / "mma_rate.so")
    procs = {k: subprocess.Popen(nvcc_command(nvcc, src, so), stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (src, so) in jobs.items()}
    for key, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
    return {k: so for k, (_, so) in jobs.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path,
                        default=ROOT / "graph_weather_tpu_torch" / "_build" / "k3_variants")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device; this script times kernels on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from graph_weather_tpu_torch.models.gencast.graphs import build_graphcast_graphs
    from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
    from graph_weather_tpu_torch.ops import _build
    from graph_weather_tpu_torch.ops import clustered_flash as cf

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    libs = build(args.out, _build._nvcc())
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    # The mma probe: independent chains per warp, 8 warps per block.
    probe = ctypes.CDLL(str(libs[("probe", "mma_rate")])).mma_rate
    probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 4 * 256, device="cuda")
    for chains in (1, 2, 4):
        for per_sm in (1, 2, 4):
            blocks, iters = sms * per_sm, 4096
            probe(out.data_ptr(), chains, blocks, 64, stream())
            ms = cs.cuda_ms(lambda: probe(out.data_ptr(), chains, blocks, iters, stream()), runs=3, batch=1)
            hmma = blocks * 8 * iters * chains
            print(f"[mma] {chains} chains per warp, {8 * per_sm} warps per SM: "
                  f"{hmma * 2048 / ms / 1e9:.1f} TFLOP/s of TF32", flush=True)

    gc = cs.GENCAST
    graphs = build_graphcast_graphs(gc["grid_lon"], gc["grid_lat"], splits=5, num_hops=4,
                                    add_edge_features_to_khop=False, spatial_sort="rcb")
    khop = DeviceGraph.from_bundle(graphs.khop, "cuda", clustered=True)
    ids, masks, block = khop.cluster_ids, khop.cluster_masks, khop.cluster_block
    nb, u_pad = ids.shape
    n = nb * block
    gen = torch.Generator(device="cuda").manual_seed(0)
    for c in (128, 512):
        q, k, v, dout = (torch.randn(1, n, 4, c, generator=gen, device="cuda") for _ in range(4))
        ref, ref_lse = cf.clustered_flash_forward_reference(q, k, v, ids, masks, block, with_lse=True)
        want = cf.clustered_flash_backward_reference(q, k, v, ids, masks, ref, ref_lse, dout, block,
                                                     symmetric=True)
        delta = (dout * ref).sum(-1).contiguous()
        for name in VARIANTS:
            fwd = ctypes.CDLL(str(libs[(name, "clustered_flash")])).gwt_clustered_flash_forward
            fwd.argtypes, fwd.restype = cf._FWD_ARGTYPES, ctypes.c_int
            bwd = ctypes.CDLL(str(libs[(name, "clustered_flash_bwd")])).gwt_clustered_flash_backward
            bwd.argtypes, bwd.restype = cf._BWD_ARGTYPES, ctypes.c_int
            o, lse = torch.zeros_like(q), torch.zeros(1, n, 4, device="cuda")
            dq, dk, dv = (torch.zeros_like(q) for _ in range(3))

            def run_fwd():
                err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), ids.data_ptr(), masks.data_ptr(),
                          o.data_ptr(), lse.data_ptr(), 1, n, n, 4, c, nb, block, u_pad, 1,
                          1.0 / c**0.5, stream())
                if err:
                    raise RuntimeError(f"{name}: forward launch failed ({err})")

            def run_bwd(mode):
                err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), ref_lse.data_ptr(),
                          delta.data_ptr(), ids.data_ptr(), masks.data_ptr(),
                          dq.data_ptr() if mode == 1 else 0, dk.data_ptr() if mode == 2 else 0,
                          dv.data_ptr() if mode == 2 else 0, 1, n, n, 4, c, nb, block, u_pad, 1,
                          1.0 / c**0.5, mode, stream())
                if err:
                    raise RuntimeError(f"{name}: backward launch failed ({err})")

            run_fwd(), run_bwd(1), run_bwd(2)
            torch.cuda.synchronize()
            err_f = max((o - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
            err_b = max((a - b).abs().max().item() for a, b in zip((dq, dk, dv), want))
            print(f"[k3] c={c} {name:12s} forward_ms={cs.cuda_ms(run_fwd):.4f} "
                  f"dq_ms={cs.cuda_ms(lambda: run_bwd(1)):.4f} dkv_ms={cs.cuda_ms(lambda: run_bwd(2)):.4f} "
                  f"max_abs_err forward {err_f:.2e} backward {err_b:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
