"""How long chip_smoke.py's CPU references (CPU_JOBS) take beside its nvcc
build, by pool shape: for each `processes x threads`, a fresh build of every
csrc/*.cu (into a temporary directory) and the pool started together, as
chip_smoke.py's phase 2 starts them, the pool then left to finish alone (in
chip_smoke.py it runs on beside the card's untimed work); the build's
seconds, the pool's, and each job's.

    python3 scripts/cpu_refs_timing.py [--configs 4x2,8x1,1x8] [--out FILE]

`1x8` is the jobs one after another at 8 threads, as the phases ran them
before. Needs nvcc (the CUDA toolkit); the jobs run on the CPU and
never touch the card. One JSON line per config.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from graph_weather_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--configs", default="4x2,8x1,1x8")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    lines = []
    for config in args.configs.split(","):
        processes, threads = (int(x) for x in config.split("x"))
        with tempfile.TemporaryDirectory() as tmp:
            _build.BUILD_DIR = Path(tmp)
            _build._LIBRARIES.clear()
            t0 = time.perf_counter()
            refs = chip_smoke.CpuReferences(processes, threads)
            try:
                _build.load_libraries(_build.all_sources())
                build_s = time.perf_counter() - t0
                jobs_s = {name: refs.get(name)["seconds"] for name in refs.jobs}
                total = time.perf_counter() - t0
                refs.close()
            finally:
                refs.stop()
        line = json.dumps({"processes": processes, "threads": threads, "build_s": build_s,
                           "pool_s": total, "waited_after_build_s": total - build_s,
                           "jobs_s": jobs_s})
        print(line, flush=True)
        lines.append(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
