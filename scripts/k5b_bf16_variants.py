"""K5b·bf16's dk/dv kernel (csrc/natten_flash_bwd.cu, `natten_dkv_bf16_kernel`)
at the 128-d WeatherMesh's layer (case a: [1, 14, 45, 90], 4 heads x 32,
kernel (3, 5, 5), rpb) on one NVIDIA GPU, against variants and ablations of
its source: builds each copy of the source (nvcc processes started
together), swaps it in for the port's library, and times the dk/dv kernel on
the plan's key tile (CUDA-event medians of batches of 5 launches).

    python3 scripts/k5b_bf16_variants.py

Variants, each checked against the source's dk and dv (bit for bit, or
within the bf16 rule of the plain version where its arithmetic differs):
  base        the source as it is (p by ex2.approx.ftz)
  exp2f       p by exp2f, which keeps subnormal results
Ablations (their dk and dv are wrong; timed only):
  no_scale    q-hat not formed (the in-place pass over each staged item)
  no_copy     only the first item copied (the others reuse stale stages)
  no_walk     nothing walked: copies, q-hat and the barriers alone

Prints one line per variant and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from graph_weather_tpu_torch.ops import _build, natten_flash  # noqa: E402

SOURCE = ROOT / "graph_weather_tpu_torch" / "csrc" / "natten_flash_bwd.cu"
VARIANTS = {
    "base": [],
    "exp2f": [("ex2_ftz(fmaf(sv, LOG2E, -f.x))", "exp2f(fmaf(sv, LOG2E, -f.x))")],
    "no_scale": [("    scale_item(it, s & 1);\n", "")],
    "no_copy": [("    if (nx.y0 < hi_h) copy_item(nx, (s + 1) & 1);",
                 "    if (nx.y0 < hi_h && s < 0) copy_item(nx, (s + 1) & 1);")],
    "no_walk": [("    if (live) walk(it, s & 1);", "    if (live && p.g.batch < 0) walk(it, s & 1);")],
}
CHECKED = {"base": "equal", "exp2f": "rule"}


def build_all(out_dir: Path) -> dict:
    text = SOURCE.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src_text = text
        for old, new in edits:
            if old not in src_text:
                raise RuntimeError(f"{name}: the source has no {old!r}")
            src_text = src_text.replace(old, new)
        src = out_dir / f"k5b_{name}.cu"
        src.write_text(src_text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SOURCE.parent), "-o",
             str(out_dir / f"k5b_{name}.so"), str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(out_dir / f"k5b_{name}.so"))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k5b_bf16_variants: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernel, heads, ch = (3, 5, 5), 4, 32
    _build.load_libraries(["natten_flash", "natten_flash_bwd"])
    q, k, v, rpb = cs.natten_bf16_inputs(gen, kernel, heads, ch)
    out, lse = natten_flash._forward_cuda(q, k, v, kernel, rpb, False, with_lse=True)
    dout = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    want = natten_flash.natten_flash_backward_reference(q, k, v, rpb, out, lse, dout, kernel, False)
    plan = natten_flash.dkv_bf16_plan(cs.WM_LATENT, kernel, False, heads, ch, True)
    own = _build._LIBRARIES["natten_flash_bwd"]
    result, base = {}, None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, lib in build_all(Path(tmp)).items():
                _build._LIBRARIES["natten_flash_bwd"] = lib
                grads = tuple(torch.empty_like(q) for _ in range(3))

                def launch(grads=grads):
                    natten_flash.launch_backward(natten_flash.DKV, q, k, v, rpb, dout, lse, delta, grads,
                                                 None, kernel, False)

                launch()
                torch.cuda.synchronize()
                check = CHECKED.get(name)
                if check == "equal" and base is not None:
                    ok = torch.equal(grads[1], base[1]) and torch.equal(grads[2], base[2])
                elif check is not None:
                    ok = max(cs.bf16_err(a, b)[1] for a, b in zip(grads[1:], want[1:3])) <= 1.0
                else:
                    ok = None
                if name == "base":
                    base = tuple(t.clone() for t in grads)
                if ok is False:
                    raise AssertionError(f"{name}: dk/dv off")
                ms = cs.cuda_ms(launch)
                result[name] = {"ms": ms, "checked": ok}
                print(f"[k5b_bf16_variants] {name}: dk/dv {ms:.4f} ms a case-a layer (plan {plan.tile.td} x "
                      f"{plan.tile.th} x {plan.tile.tw}, {plan.ctas} CTAs an SM) | checked {ok}", flush=True)
    finally:
        _build._LIBRARIES["natten_flash_bwd"] = own
    print(json.dumps({"variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
