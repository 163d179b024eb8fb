"""Tile shapes of K3c·bf16 at 128 < c <= 256 (csrc/clustered_flash_bwd.cu,
the M192 tile) on one NVIDIA GPU: builds copies of the source with the M192
tile replaced, and times K3c's dq and symmetric dk/dv kernels in bf16 at c
= 192 on FGN's splits-6 layout (chip_smoke.py's FGN), each checked against
the plain backward (chip_smoke.py's BF16_TOL rule), with CTAs an SM.

    python3 scripts/k3c_bf16_variants.py [--c 192]

Variants (CP, RG row groups, CS warps a group, TB streamed rows):
  m192        the source as it is: Cfg<T, 192, 4, 2, 48>
  tb32        32 streamed rows a tile: Cfg<T, 192, 4, 2, 32>
  ta32        2 row groups, 128 threads, two CTAs an SM by registers:
              Cfg<T, 192, 2, 2, 32>
  cs3         2 row groups of 3 warps of 64 channels: Cfg<T, 192, 2, 3, 32>
  w256        the W256 tile K3c took before (Cfg<T, 256, 2, 4, 16>)

Prints one line per variant and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from graph_weather_tpu_torch.ops import _build, clustered_flash  # noqa: E402

SOURCE = ROOT / "graph_weather_tpu_torch" / "csrc" / "clustered_flash_bwd.cu"
M192 = "template <class T> using M192 = Cfg<T, 192, 4, 2, 48>;"
CHECK = "THREADS == 256 &&"  # the source's tile assert
VARIANTS = {
    "m192": M192,
    "tb32": "template <class T> using M192 = Cfg<T, 192, 4, 2, 32>;",
    "ta32": "template <class T> using M192 = Cfg<T, 192, 2, 2, 32>;",
    "cs3": "template <class T> using M192 = Cfg<T, 192, 2, 3, 32>;",
    "w256": "template <class T> using M192 = Cfg<T, 256, 2, 4, 16>;",
}


def build_all(out_dir: Path) -> dict:
    """Every variant's library, built by nvcc processes started together."""
    text = SOURCE.read_text()
    if M192 not in text or CHECK not in text:
        raise RuntimeError("the source has no M192 line or tile assert to replace")
    procs = {}
    for name, line in VARIANTS.items():
        src = out_dir / f"k3c_{name}.cu"
        # the variants of fewer than 256 threads pass the tile's assert here only
        src.write_text(text.replace(M192, line).replace(CHECK, "THREADS <= 256 &&"))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SOURCE.parent), "-o",
             str(out_dir / f"k3c_{name}.so"), str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        libs[name] = load(out_dir / f"k3c_{name}.so", log, VARIANTS[name])
    return libs


def load(so: Path, log: str, line: str) -> ctypes.CDLL:
    """The library, with ptxas's registers of the variant's bf16 kernels."""
    cfg = "".join(f"Li{n}E" for n in re.search(r"Cfg<T, ([\d, ]+)>", line).group(1).split(", "))
    regs, entry = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif "registers" in ln and cfg in entry and "bfloat16" in entry:
            regs.append(ln.split(":", 1)[-1].strip())
    lib = ctypes.CDLL(str(so))
    lib.gwt_clustered_flash_backward.argtypes = clustered_flash._BWD_ARGTYPES
    lib.gwt_clustered_flash_backward.restype = ctypes.c_int
    lib.gwt_clustered_flash_backward_ctas.argtypes = [ctypes.c_int] * 5
    lib.gwt_clustered_flash_backward_ctas.restype = ctypes.c_int
    lib.regs = regs
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--c", type=int, default=192)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k3c_bf16_variants: no CUDA device", file=sys.stderr)
        return 1
    import graph_weather_tpu_torch as port

    c, heads = args.c, 4
    khop = port.FunctionalGenerativeNetwork(**cs.FGN, device="cuda").khop
    ids, masks, block = khop.cluster_ids, khop.cluster_masks, khop.cluster_block
    nb, u_pad = ids.shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(1, nb * block, heads, c, generator=gen, device="cuda").bfloat16()
                     for _ in range(4))
    out, lse = clustered_flash._forward_cuda(q, k, v, ids, masks, block, with_lse=True)
    want = clustered_flash.clustered_flash_backward_reference(q, k, v, ids, masks, out, lse, dout, block,
                                                               symmetric=True)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, lib in build_all(Path(tmp)).items():
            grads = [torch.empty_like(q) for _ in range(3)]

            def launch(mode, lib=lib, grads=grads):
                outs = (grads[0], None, None) if mode == 1 else (None, grads[1], grads[2])
                err = lib.gwt_clustered_flash_backward(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), ids.data_ptr(), masks.data_ptr(),
                    *(0 if t is None else t.data_ptr() for t in outs), 1, q.shape[1], k.shape[1], heads,
                    c, nb, block, u_pad, 1, 1.0 / c**0.5, mode, 1, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")

            launch(1), launch(2)
            torch.cuda.synchronize()
            err = max(cs.bf16_err(a, b)[1] for a, b in zip(grads, want))
            if not err <= 1.0:
                raise AssertionError(f"{name}: error {err} x the bf16 rule")
            row = {"dq_ms": cs.cuda_ms(lambda: launch(1)), "dkv_ms": cs.cuda_ms(lambda: launch(2)),
                   "err_over_limit": err, "regs": lib.regs,
                   "ctas": [lib.gwt_clustered_flash_backward_ctas(c, block, u_pad, m, 1) for m in (1, 2)]}
            result[name] = row
            print(f"[k3c_bf16_variants] c={c} {name}: dq {row['dq_ms']:.4f} ms + dk/dv "
                  f"{row['dkv_ms']:.4f} = {row['dq_ms'] + row['dkv_ms']:.4f} | error {err:.3f} of the "
                  f"rule | CTAs an SM (dq, dk/dv) {row['ctas']}", flush=True)
    print(json.dumps({"c": c, "variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
