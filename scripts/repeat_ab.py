"""Times f32 train steps of the GenCast denoiser and the 128-d and 768-d
WeatherMesh on one NVIDIA GPU with their sums and convolution backwards in a
fixed order (as the port runs them) and as they ran before (atomics), and
checks whether each repeats its loss and gradients bit for bit:

    python3 scripts/repeat_ab.py [--only gencast,wm128,wm768]

Modes, applied to the same weights and batch in one process:
  * fixed: the port as it is: GenCast's graph sums in edge order (S in f32)
    and the gathers' gradients on S; WeatherMesh's conv backward on cuDNN's
    deterministic algorithms and its resize backward a product;
  * atomics: the sums before: index_add_ for GenCast's grid->mesh
    aggregation and for the gathers' and the padded table's gradients;
    cuDNN's default conv backward and F.interpolate's backward;
  * tables (GenCast only): the alternative to S, the graphs' padded-CSR
    levels (DeviceGraph edge_sums=True, as the forecaster's) for the
    aggregation and for the gathers' gradients;
  * bench (WeatherMesh only): fixed, with cuDNN's autotuner on in the conv
    backward too (the fastest of its deterministic algorithms per shape).
The configurations are chip_smoke.py's (phases 15, 23 and 42: full width,
B = 1, 1 deg for WeatherMesh). Per mode: 3 train steps (make_train_step,
clip + AdamW), ms of each and the median of steps 2-3, then the loss and
gradients twice at those weights: bit-equal or not. One JSON line per
model. f32 throughout; TF32 is off.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]


class _TableGather(torch.autograd.Function):
    """A gather onto edges whose gradient sums through padded-CSR levels."""

    @staticmethod
    def forward(ctx, x, index, levels):
        ctx.levels = levels
        return x.index_select(-2, index)

    @staticmethod
    def backward(ctx, grad):
        from graph_weather_tpu_torch.ops.scatter import chunked_csr_agg

        return chunked_csr_agg(grad.contiguous(), ctx.levels), None, None


@contextlib.contextmanager
def patched(mode: str, graphs=None):
    """The sums of `mode` (see the module docstring) while inside."""
    from graph_weather_tpu_torch.models.weathermesh import model as wm_model
    from graph_weather_tpu_torch.nn import graph_blocks

    saved = (graph_blocks.gather_rows, graph_blocks.DeviceGraph.aggregate,
             wm_model._deterministic_cudnn, wm_model._Resize.apply)
    try:
        if mode == "atomics":
            from graph_weather_tpu_torch.ops.scatter import segment_sum_agg

            aggregate = saved[1]
            graph_blocks.DeviceGraph.aggregate = lambda self, e: (
                segment_sum_agg(e, self.receivers.long(), self.n_receivers)
                if self.sum_route(e.dtype) == "edge_order" else aggregate(self, e))
            graph_blocks.gather_rows = lambda x, index, csr: x.index_select(-2, index)
            wm_model._deterministic_cudnn = contextlib.nullcontext
            wm_model._Resize.apply = lambda x, scale, mode: F.interpolate(
                x, scale_factor=scale, mode=mode, align_corners=False)
        elif mode == "bench":
            @contextlib.contextmanager
            def tuned():
                with saved[2](), torch.backends.cudnn.flags(
                        enabled=True, benchmark=True, deterministic=True,
                        allow_tf32=torch.backends.cudnn.allow_tf32):
                    yield

            wm_model._deterministic_cudnn = tuned
        elif mode == "tables":
            levels = {id(csr): lv for g in graphs for csr, lv in
                      ((g.sender_csr, g.sender_sum), (g.receiver_csr, g.receiver_sum))}
            graph_blocks.gather_rows = lambda x, index, csr: _TableGather.apply(x, index, levels[id(csr)])
        yield
    finally:
        (graph_blocks.gather_rows, graph_blocks.DeviceGraph.aggregate,
         wm_model._deterministic_cudnn, wm_model._Resize.apply) = saved


def run_modes(cs, name, model, batch, objective, modes, graphs_for=None) -> dict:
    """3 train steps and a repeat check per mode, from the same weights."""
    port = sys.modules["graph_weather_tpu_torch"]
    weights = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
    result = {}
    for mode in modes:
        model.module.load_state_dict(weights)
        with patched(mode, graphs_for(mode) if graphs_for else None):
            step = port.make_train_step(model.module.parameters(), model.forward_fn(), objective,
                                        port.make_optimizer(1e-4))
            torch.cuda.reset_peak_memory_stats()
            ms = [cs.timed(lambda: step(*batch))[1] for _ in range(3)]

            def value_and_grads():
                model.module.zero_grad(set_to_none=True)
                value = objective(model.forward_fn()(*batch[:-1]), batch[-1])
                value.backward()
                grads = {k: t.grad.clone() for k, t in model.module.named_parameters()}
                model.module.zero_grad(set_to_none=True)
                return value.item(), grads

            (v1, g1), (v2, g2) = value_and_grads(), value_and_grads()
        differ = [k for k in g1 if not torch.equal(g1[k], g2[k])]
        result[mode] = dict(step_ms=[round(t, 3) for t in ms], median_ms=statistics.median(ms[1:]),
                            peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2),
                            loss_repeats=v1 == v2, grads_differ=len(differ), of=len(g1))
        print(f"[repeat_ab] {name} {mode}: {result[mode]}", flush=True)
        del step
        torch.cuda.empty_cache()
    model.module.load_state_dict(weights)
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default="gencast,wm128,wm768")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("repeat_ab: no CUDA device; this script times the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import graph_weather_tpu_torch as port
    from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
    from graph_weather_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.load_libraries(_build.all_sources())
    only = args.only.split(",")
    out = {"card": card}
    if "gencast" in only:
        den = port.Denoiser(**cs.GENCAST, device="cuda")
        den.init(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(3)
        f_in, f_out = cs.GENCAST["input_features_dim"], cs.GENCAST["output_features_dim"]
        batch = [torch.randn(1, 128, 64, f, generator=gen).cuda() for f in (f_out, 2 * f_in, f_out)]
        noise = port.sample_noise_level(torch.Generator(device="cuda").manual_seed(4), (1, 1))
        loss = port.WeightedMSELoss(grid_lat=cs.GENCAST["grid_lat"], device="cuda")
        plain = (den.g2m, den.m2g)
        tables = tuple(DeviceGraph.from_bundle(b, "cuda", edge_sums=True)
                       for b in (den.graphs.g2m, den.graphs.m2g))

        ownerless = dataclasses.replace(plain[1], csr_owner=None)  # index_select's own gradient

        def graphs_for(mode):
            den.g2m, den.m2g = {"tables": tables, "atomics": (plain[0], ownerless)}.get(mode, plain)
            return tables

        out["gencast"] = run_modes(
            cs, "gencast", den, (batch[0], batch[1], noise, batch[2]),
            lambda pred, target: loss(pred, noise, target), ("fixed", "atomics", "tables", "fixed"),
            graphs_for)
        den.g2m, den.m2g = plain
        del den
    for key, cfg in (("wm128", cs.WEATHERMESH), ("wm768", cs.WM_WIDE)):
        if key not in only:
            continue
        wm = port.WeatherMesh(**cfg, device="cuda")
        wm.init(torch.Generator().manual_seed(0))
        with torch.no_grad():  # chip_smoke's phase 19: the attention projections' biases at 0
            for name, t in wm.module.named_parameters():
                if name.endswith(("qkv.bias", "proj.bias")):
                    t.zero_()
        h, w = cs.WM_GRID
        levels = cfg["pressure_levels"]
        gen = torch.Generator().manual_seed(5)
        surface, t_surface = (torch.randn(1, h, w, 8, generator=gen).cuda() for _ in range(2))
        pressure, t_pressure = (torch.randn(1, levels, h, w, 4, generator=gen).cuda() for _ in range(2))

        def objective(pred, target):
            return (torch.mean((pred.surface - target[0]) ** 2)
                    + torch.mean((pred.pressure - target[1]) ** 2))

        out[key] = run_modes(cs, key, wm, (surface, pressure, (t_surface, t_pressure)), objective,
                             ("fixed", "atomics", "bench", "fixed"))
        del wm
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
