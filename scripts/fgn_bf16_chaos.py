"""Readings of FGN's bf16 chaos at full width on one NVIDIA GPU. For each
seed of weights and inputs, the bf16 member of chip_smoke.py's phase 61
(FGN at bench.py's widths with 2 blocks: one at c = 192, the last at
c = 768) runs on the card and on the CPU, and again on an input with one
bf16 ulp on 1 in 2,000 elements (chip_smoke.one_ulp_off). Printed, each over
the card's bf16-to-f32 distance (output RMSE; gradients of the MSE loss in
global norm): the card against the CPU; the CPU against its own one-ulp run
(at the first flip seed, as phase 61 takes it); the card against its own
one-ulp run at each flip seed. Where the card's distance from the CPU is of
the size of what one ulp does to either, the bf16 path is chaotic there,
and a limit below that size would fail a correct port.

    python3 scripts/fgn_bf16_chaos.py [--seeds 6,7,8] [--flips 10,11,12]

One line per seed, then one JSON line with the card's name and power
limit. About two minutes of CPU a seed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", default="6,7,8")
    parser.add_argument("--flips", default="10,11,12")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("fgn_bf16_chaos: no CUDA device; this script runs the port on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import graph_weather_tpu_torch as port
    from graph_weather_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.load_libraries(_build.all_sources())
    f32, bf16 = torch.float32, torch.bfloat16
    short = {**cs.FGN, "num_blocks": cs.FGN_CHECK_BLOCKS}
    n_lon, n_lat = len(cs.FGN["grid_lon"]), len(cs.FGN["grid_lat"])
    flips = [int(f) for f in args.flips.split(",")]
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        card2 = port.FunctionalGenerativeNetwork(**short, device="cuda")
        card2.init(torch.Generator().manual_seed(seed))
        cpu2 = port.FunctionalGenerativeNetwork(**short, device="cpu")
        cpu2.module.load_state_dict({k: v.cpu() for k, v in card2.module.state_dict().items()})
        data = torch.Generator().manual_seed(1000 + seed)
        x = torch.randn(1, n_lon, n_lat, cs.FGN["input_features_dim"], generator=data)
        z = torch.randn(1, cs.FGN["noise_dimension"], generator=data)
        tgt = torch.randn(1, n_lon, n_lat, cs.FGN["output_features_dim"], generator=data)

        def run(model, dtype, state):
            model.module.zero_grad(set_to_none=True)
            dev = model.device
            out = model.member_fn(compute_dtype=dtype)(state.to(dev), z.to(dev))
            torch.mean((out - tgt.to(dev)) ** 2).backward()
            grads = {k: t.grad.cpu() for k, t in model.module.named_parameters()}
            model.module.zero_grad(set_to_none=True)
            return out.detach().cpu(), grads

        def distance(a, b):
            return (cs.rmse(a[0], b[0]),
                    cs.global_norm({k: a[1][k] - b[1][k] for k in a[1]}))

        card32, card16 = run(card2, f32, x), run(card2, bf16, x)
        scale = distance(card16, card32)

        def share(a, b):
            return [round(d / s, 4) for d, s in zip(distance(a, b), scale)]

        flipped = [cs.one_ulp_off(x, f)[0] for f in flips]
        card_own = [share(card16, run(card2, bf16, state)) for state in flipped]
        cpu16 = run(cpu2, bf16, x)
        row = dict(seed=seed, card_vs_cpu=share(card16, cpu16),
                   cpu_own=share(cpu16, run(cpu2, bf16, flipped[0])), card_own=card_own,
                   seconds=round(time.perf_counter() - t0, 1))
        rows.append(row)
        print(f"[fgn_bf16_chaos] seed {seed}: (output, gradients) over card bf16 - card f32 | card - "
              f"CPU {row['card_vs_cpu']} | CPU's own one-ulp reading (flip seed {flips[0]}) "
              f"{row['cpu_own']} | card's own at flip seeds {flips} {card_own} | "
              f"{row['seconds']} s", flush=True)
        del card2, cpu2
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
