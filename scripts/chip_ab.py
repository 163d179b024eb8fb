"""Times the GenCast, forecaster and WeatherMesh paths of one checkout of the
PyTorch/CUDA port on one NVIDIA GPU, so that two trees can be compared on
one card in one call, in turns (parent, change, change, parent):

    python3 scripts/chip_ab.py --root DIR [--label NAME]

DIR is the root of a checkout whose graph_weather_tpu_torch/ is timed (the
package builds its kernels into DIR). The measurements are chip_smoke.py's,
from this script's own checkout: K3a at c = 128 and 512 against SDPA on the
gathered unions (phase 8), K3c and K3b with SDPA's backward (phase 14), per
evaluation and per train step; 3 GenCast denoiser requests (phase 9), one
20-step sample (11), 3 train steps (15); the fused edge update's kernels
at the 1° forecaster's shapes, K1 and K2 per forward (phase 3) and K2b per
train step (33); 3 forecaster requests at 1° (4) and 3 train steps (34); K4a (phase 26) and K4b's two kernels (27) on the
splits-5 band layout at c = 128 and 512 (the dk/dv kernel in its symmetric
role where the tree has one), per evaluation and per train step, 3 banded
GenCast requests (28) and 3 banded train steps (30); K6 on the 768-d
WeatherMesh's layer (phase 37, case a), 3 requests of the 768-d WeatherMesh
(38) and 3 of the 128-d one (19); K5a at phase 18's cases a and c, with and
without lse, and on phase 37's case a (the 768-d layer, which `route`
sends to K6) with its `takes` bypassed here only; K5b's dq and dk/dv
kernels apart on the 128-d layer (phase 22, case a) and 3 128-d
WeatherMesh train steps (23); where the tree has K6b, its dq and dk/dv
kernels apart on the 768-d layer (phase 41, case a), K6 with lse, and 3
768-d WeatherMesh train steps (42) and their peak GiB; the whole K6b
backward (both kernels, with delta apart where the tree's dq kernel does
not form it, the slot table where the tree has one, the drpb sum).
Each kernel is held against its plain version as in those phases. Prints
one JSON line. f32 throughout; TF32 is off.

    python3 scripts/chip_ab.py --root DIR --only bf16_backward

times only the bf16 backward kernels and what they are held to (phases 51
and 57): K5b·bf16's dq and dk/dv kernels apart on the 128-d WeatherMesh's
layer (case a), the f32 kernels on the same values, the whole backward,
SDPA's bf16 backward, the dk/dv kernel on other key tiles; K3c (and K3a)
on FGN's splits-6 layout at c = 128, 192, 512 and 768 in f32 and bf16,
with SDPA's backward and CTAs an SM (`--only k5_bf16`: K5b·bf16 alone).
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def k5a_cases(cs, natten_flash, gen) -> dict:
    """K5a at phase 18's cases a ((3, 5, 5), 4 x 32: the 128-d WeatherMesh's
    layers) and c ((5, 7, 7), 8 x 32), with and without lse, after a check
    of out and lse against the plain version; per launch, and per forward (8
    launches of case a)."""
    from graph_weather_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_3d_reference,
    )

    result = {}
    for name, (kernel, heads) in {"a": ((3, 5, 5), 4), "c": ((5, 7, 7), 8)}.items():
        q, k, v, rpb = cs.natten_inputs(gen, kernel, heads)
        out, lse = natten_flash._forward_cuda(q, k, v, kernel, rpb, False, with_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = neighborhood_attention_3d_reference(q, k, v, kernel, rpb, False, with_lse=True)
        err = max((out - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
        if not err <= cs.K5_TOL:
            raise AssertionError(f"K5a case {name}: error {err} > {cs.K5_TOL}")
        for lse_ in (False, True):
            key = f"k5a_{name}{'_lse' if lse_ else ''}_ms_per_layer"
            result[key] = cs.cuda_ms(
                lambda: natten_flash._forward_cuda(q, k, v, kernel, rpb, False, with_lse=lse_))
        result[f"k5a_{name}_max_abs_err"] = err
    result["k5a_ms_per_forward"] = cs.K5_PER_FORWARD * result["k5a_a_ms_per_layer"]
    return result


def k5b_split(cs, natten_flash, gen) -> dict:
    """K5b's dq kernel (with its drpb partials) and dk/dv kernel apart on the
    128-d WeatherMesh's layer (phase 22, case a), after a check of the whole
    backward against its plain version. A tree without
    `natten_flash.launch_backward` (before the kernels could be launched
    apart) is driven through its C entry as its own wrapper drove it."""
    kernel, heads, circular = (3, 5, 5), 4, False
    q, k, v, rpb = cs.natten_inputs(gen, kernel, heads)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    out, lse = natten_flash._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True)
    args = (q, k, v, rpb, out, lse, dout, kernel, circular)
    got = natten_flash._backward_cuda(*args)
    torch.cuda.synchronize()
    want = natten_flash.natten_flash_backward_reference(*args)
    err = max((a - b).abs().max().item() for a, b in zip(got[:3], want[:3]))
    if not err <= cs.K5_TOL:
        raise AssertionError(f"K5b: error {err} > {cs.K5_TOL}")
    delta = (dout * out).sum(-1).contiguous()
    grads = tuple(torch.empty_like(q) for _ in range(3))
    dims, ch = tuple(q.shape[1:4]), q.shape[-1]
    partial = torch.empty(natten_flash._pick_tile("dq", dims, kernel, circular, ch, True).n_tiles,
                          heads, rpb[0].numel(), device="cuda")
    if hasattr(natten_flash, "launch_backward"):
        def launch(mode):
            return lambda: natten_flash.launch_backward(
                mode, q, k, v, rpb, dout, lse, delta, grads, partial, kernel, circular)
    else:
        fn = natten_flash.c_function("natten_flash_bwd", "gwt_natten_flash_backward",
                                     natten_flash._BWD_ARGTYPES)

        def launch(mode):
            tile = natten_flash._pick_tile(("dq", "dkv")[mode], dims, kernel, circular, ch, True)
            geometry = natten_flash._geometry(q, k, v, kernel, circular, tile, (q, k, v, dout, *grads))
            outs = (grads[0], None, None, partial) if mode == 0 else (None, grads[1], grads[2], None)

            def run():
                if fn(mode, q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(), dout.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), *(natten_flash._ptr(t) for t in outs), *geometry):
                    raise RuntimeError("K5b launch failed")
            return run
    dq_ms, dkv_ms = cs.cuda_ms(launch(0)), cs.cuda_ms(launch(1))
    return {"k5b_max_abs_err": err, "k5b_dq_ms_per_layer": dq_ms, "k5b_dkv_ms_per_layer": dkv_ms,
            "k5b_ms_per_layer": cs.cuda_ms(lambda: natten_flash._backward_cuda(*args)),
            "k5b_dq_ms_per_step": cs.K5_PER_FORWARD * dq_ms,
            "k5b_dkv_ms_per_step": cs.K5_PER_FORWARD * dkv_ms}


def k5a_on_wide_heads(cs, natten_flash, natten3d, gen) -> dict:
    """K5a on the 768-d WeatherMesh's layer (phase 37's case a: 8 x 96 at
    (5, 7, 7)), which `route` sends to K6: launched here with `takes`
    bypassed (the halo check that keeps the shape off K5a), on the plan
    `_fwd_plan` gives it, after a check of out and lse against the plain
    version; K6 on the same inputs beside it. Only this script launches K5a
    on such a shape; routing is unchanged. {} for a tree without
    `_fwd_plan`."""
    from graph_weather_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_3d_reference,
    )

    if not hasattr(natten_flash, "_fwd_plan"):
        return {}
    kernel, heads, ch = (5, 7, 7), 8, 96
    q, k, v, rpb = cs.natten_inputs(gen, kernel, heads, ch)
    plan = natten_flash._fwd_plan(tuple(q.shape[1:4]), kernel, False, ch, True)
    takes = natten_flash.takes
    natten_flash.takes = lambda *args, **kwargs: True
    try:
        out, lse = natten_flash._forward_cuda(q, k, v, kernel, rpb, False, with_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = neighborhood_attention_3d_reference(q, k, v, kernel, rpb, False, with_lse=True)
        err = max((out - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
        if not err <= cs.K5_TOL:
            raise AssertionError(f"K5a on the 768-d layer: error {err} > {cs.K5_TOL}")
        ms = cs.cuda_ms(lambda: natten_flash._forward_cuda(q, k, v, kernel, rpb, False, with_lse=False))
    finally:
        natten_flash.takes = takes
    k6_ms = cs.cuda_ms(lambda: natten3d._forward_cuda(q, k, v, kernel, rpb, False))
    return {"k5a_wide_plan": str(plan), "k5a_wide_max_abs_err": err, "k5a_wide_ms_per_layer": ms,
            "k6_wide_ms_per_layer_same_inputs": k6_ms}


def k6b_split(cs, natten3d, natten_flash, gen) -> dict:
    """K6b's dq kernel (with its drpb partials, and the slot table's writes
    where the tree has one) and dk/dv kernel apart on the 768-d
    WeatherMesh's layer (phase 41, case a), and the whole backward (both
    kernels, delta where the tree computes it apart, the drpb sum), after a
    check of the whole backward against its plain version. {} for a tree
    without K6b; a tree whose `launch_backward` takes no slot table (before
    the dk/dv kernel read p and ds from one) is launched without one, with
    delta."""
    if not hasattr(natten3d, "launch_backward"):
        return {}
    kernel, heads, ch, circular = (5, 7, 7), 8, 96, False
    q, k, v, rpb = cs.natten_inputs(gen, kernel, heads, ch)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    out, lse = natten3d._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True)
    args = (q, k, v, rpb, out, lse, dout, kernel, circular)
    got = natten3d._backward_cuda(*args)
    torch.cuda.synchronize()
    want = natten_flash.natten_flash_backward_reference(*args)
    err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))
    if not err <= cs.K5_TOL:
        raise AssertionError(f"K6b: error {err} of max|g| > {cs.K5_TOL}")
    del got, want
    delta = (dout * out).sum(-1).contiguous()
    grads = tuple(torch.empty_like(q) for _ in range(3))
    plan = natten3d.plan_backward(tuple(q.shape), kernel, circular, True)[natten3d.DQ]
    partial = torch.empty(plan.n_tiles, heads, rpb[0].numel(), device="cuda")
    table, stat = (), delta  # a parent's kernels read delta, the slot table's dq kernel out
    if "table" in inspect.signature(natten3d.launch_backward).parameters:
        table, stat = (torch.empty(natten3d.table_shape(q.shape, kernel), device="cuda"),), out

    def launch(mode):
        return lambda: natten3d.launch_backward(mode, q, k, v, rpb, dout, lse, stat, grads,
                                                partial, *table, kernel, circular)

    dq_ms, dkv_ms = cs.cuda_ms(launch(natten3d.DQ)), cs.cuda_ms(launch(natten3d.DKV))
    return {"k6b_max_abs_err": err, "k6b_dq_ms_per_layer": dq_ms, "k6b_dkv_ms_per_layer": dkv_ms,
            "k6b_backward_ms_per_layer": cs.cuda_ms(lambda: natten3d._backward_cuda(*args)),
            "k6_lse_ms_per_layer": cs.cuda_ms(
                lambda: natten3d._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True)),
            "k6b_ms_per_step": cs.K6_PER_FORWARD * (dq_ms + dkv_ms)}


def dkv_bf16_tiles(cs, natten_flash, gen, tiles=((2, 8, 4), (1, 8, 8), (4, 4, 4), (1, 16, 4), (2, 8, 8),
                                                  (2, 4, 8), (1, 8, 16))) -> dict:
    """K5b·bf16's dk/dv kernel at case a on other key tiles than its plan's
    (`dkv16_tile_plan`; the plan's function swapped here only), each
    checked bit for bit against the plan's dk and dv; ms a layer by tile."""
    kernel, heads, ch = (3, 5, 5), 4, 32
    q, k, v, rpb = cs.natten_bf16_inputs(gen, kernel, heads, ch)
    out, lse = natten_flash._forward_cuda(q, k, v, kernel, rpb, False, with_lse=True)
    dout = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    delta = (dout.float() * out.float()).sum(-1).contiguous()

    def launch(grads):
        natten_flash.launch_backward(natten_flash.DKV, q, k, v, rpb, dout, lse, delta, grads, None,
                                     kernel, False)

    want = tuple(torch.empty_like(q) for _ in range(3))
    launch(want)
    picker, times = natten_flash.dkv_bf16_plan, {}
    chosen = picker(cs.WM_LATENT, kernel, False, heads, ch, True)
    try:
        for tile in tiles:
            plan = natten_flash.dkv16_tile_plan(tile, cs.WM_LATENT, kernel, False, (chosen.jth, chosen.jtw),
                                                ch)
            if plan is None:
                continue
            natten_flash.dkv_bf16_plan = lambda *args, plan=plan: plan
            grads = tuple(torch.empty_like(q) for _ in range(3))
            launch(grads)
            torch.cuda.synchronize()
            if not (torch.equal(grads[1], want[1]) and torch.equal(grads[2], want[2])):
                raise AssertionError(f"K5b bf16 dk/dv on tile {tile} differs from the plan's")
            times[f"{tile} x{plan.ctas}"] = {"ms": cs.cuda_ms(lambda: launch(grads)), "ry": plan.ry,
                                             "warps": plan.warps, "smem": plan.tile.smem}
            if plan.ctas > 1:  # the same tile compiled for one CTA an SM
                one = dataclasses.replace(plan, ctas=1)
                natten_flash.dkv_bf16_plan = lambda *args, plan=one: plan
                times[f"{tile} x1"] = {"ms": cs.cuda_ms(lambda: launch(grads)), "ry": one.ry,
                                       "warps": one.warps, "smem": one.tile.smem}
    finally:
        natten_flash.dkv_bf16_plan = picker
    print(f"[k5_bf16] dk/dv kernel by key tile (case a, ms a layer; the plan's {(chosen.tile.td, chosen.tile.th, chosen.tile.tw)}): "
          f"{times}", flush=True)
    return times


def bf16_backward(cs, port, natten_flash, clustered_flash, with_k3=True) -> dict:
    """K5b·bf16 at case a (phase 51's `k5_bf16_case`: per train step of 8
    layers) and K3 on FGN's layout at c = 128, 192, 512 and 768 in f32 and
    bf16 (phase 57's `k3_fgn_case`: per layer), each against its plain
    version."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    k5 = cs.k5_bf16_case(natten_flash, "a", gen, (3, 5, 5), 4, False)
    result = {"k5_bf16_ms_per_step": {k: cs.K5_PER_FORWARD * v for k, v in k5["ms"].items()},
              "k5_bf16_err_over_limit": {k: e[1] for k, e in k5["errs"].items()},
              # the least time on the card (phase 51's bounds: this tree's bytes and operations)
              "k5_bf16_bound_ms_per_step": {k: cs.K5_PER_FORWARD * cs.bf16_bound(*k5[k])[0]
                                            for k in ("bwd", "dq", "dkv")}}
    if hasattr(natten_flash, "dkv16_tile_plan"):
        result["k5_bf16_dkv_tiles_ms_per_layer"] = dkv_bf16_tiles(cs, natten_flash, gen)
    if not with_k3:
        return result
    fgn = port.FunctionalGenerativeNetwork(**cs.FGN, device="cuda")
    k3 = {}
    for dtype in (torch.float32, torch.bfloat16):
        for c in (128, 192, 512, 768):
            case = cs.k3_fgn_case(clustered_flash, fgn.khop, gen, c, dtype)
            k3[f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_c{c}"] = {
                "k3c_ms": case["ms"]["k3c"], "k3a_ms": case["ms"]["k3a"], "sdpa_bwd_ms": case["sdpa_bwd_ms"],
                "k3c_err_over_limit": case["errs"]["k3c"][1], "ctas": case["ctas"]}
    result["k3_fgn_per_layer"] = k3
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", required=True, type=Path)
    parser.add_argument("--label", default=None)
    parser.add_argument("--only", choices=["bf16_backward", "k5_bf16"], default=None,
                        help="time only the bf16 backward kernels, or only K5b·bf16 (see the module "
                             "docstring)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; this script times the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import graph_weather_tpu_torch as port

    if not Path(port.__file__).resolve().is_relative_to(root):
        raise ImportError(f"graph_weather_tpu_torch imported from {port.__file__}, not {root}")
    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from graph_weather_tpu_torch.meshes.clustering import build_cluster_scatter_index
    from graph_weather_tpu_torch.meshes.graphs import (
        build_grid_to_mesh_graph,
        build_latent_graph,
        build_mesh_to_grid_graph,
    )
    from graph_weather_tpu_torch.meshes.hexmesh import get_hexmesh
    from graph_weather_tpu_torch.models.gencast.graphs import build_graphcast_graphs
    from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
    from graph_weather_tpu_torch.ops import (
        _build,
        banded_flash,
        clustered_flash,
        edge_mlp,
        fused_mlp,
        natten3d,
        natten_flash,
    )
    from graph_weather_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_3d_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.load_libraries(_build.all_sources())
    result = {"label": args.label or str(root), "card": card}
    if args.only is not None:
        result.update(bf16_backward(cs, port, natten_flash, clustered_flash, args.only == "bf16_backward"))
        print(json.dumps(result))
        return 0

    # K3a, K3c and K3b on the real splits-5 layout (phases 8 and 14).
    gc = cs.GENCAST
    graphs = build_graphcast_graphs(
        gc["grid_lon"], gc["grid_lat"], splits=5, num_hops=4,
        add_edge_features_to_khop=False, spatial_sort="rcb",
    )
    khop = DeviceGraph.from_bundle(graphs.khop, "cuda", clustered=True)
    scatter = torch.as_tensor(build_cluster_scatter_index(
        khop.cluster_ids.cpu().numpy(), khop.cluster_masks.cpu().numpy(), khop.n_senders
    ), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_eval = {128: gc["num_blocks"] - 1, 512: 1}
    k3a = {c: cs.k3a_case(clustered_flash, khop, gen, c) for c in per_eval}
    bwd = {c: cs.k3_bwd_case(clustered_flash, khop, scatter, gen, c) for c in per_eval}
    result.update({
        "k3a_ms": {c: v[1] for c, v in k3a.items()},
        "k3a_sdpa_ms": {c: v[3] for c, v in k3a.items()},
        "k3c_ms": {c: v["ms"]["k3c"] for c, v in bwd.items()},
        "k3b_ms": {c: v["ms"]["k3b"] for c, v in bwd.items()},
        "k3_bwd_sdpa_ms": {c: v["sdpa_ms"] for c, v in bwd.items()},
    })
    for key in ("k3a_ms", "k3a_sdpa_ms", "k3c_ms", "k3b_ms", "k3_bwd_sdpa_ms"):
        result[key]["per_eval_or_step"] = sum(result[key][c] * n for c, n in per_eval.items())
    del khop, graphs, scatter

    # GenCast: 3 requests, one 20-step sample, 3 train steps (phases 9, 11, 15).
    den = port.Denoiser(**gc, device="cuda")
    den.init(torch.Generator().manual_seed(0))
    data = torch.Generator().manual_seed(1)
    n_lon, n_lat, f_in, f_out = 128, 64, gc["input_features_dim"], gc["output_features_dim"]
    corrupted = torch.randn(3, 1, n_lon, n_lat, f_out, generator=data).to("cuda")
    prev = torch.randn(3, 1, n_lon, n_lat, 2 * f_in, generator=data).to("cuda")
    sigma = torch.ones(1, 1, device="cuda")
    result["gencast_request_ms"] = [cs.timed(lambda: den(x, c, sigma))[1] for x, c in zip(corrupted, prev)]
    sampler = port.Sampler(num_steps=20, device="cuda")
    noise = torch.Generator(device="cuda").manual_seed(2)
    result["sample_ms"] = cs.timed(lambda: sampler.sample(den, prev[0], noise))[1]
    train = torch.Generator().manual_seed(3)
    corrupted_t, prev_t, target_t = (
        torch.randn(1, n_lon, n_lat, f, generator=train).to("cuda") for f in (f_out, 2 * f_in, f_out)
    )
    noise_t = port.sample_noise_level(torch.Generator(device="cuda").manual_seed(4), (1, 1))
    loss = port.WeightedMSELoss(grid_lat=gc["grid_lat"], device="cuda")
    step = port.make_train_step(
        den.module.parameters(), den.forward_fn(), lambda p, t: loss(p, noise_t, t),
        port.make_optimizer(1e-4),
    )
    result["gencast_step_ms"] = [
        cs.timed(lambda: step(corrupted_t, prev_t, noise_t, target_t))[1] for _ in range(3)
    ]
    del den, sampler, step
    torch.cuda.empty_cache()

    # K1, K2 and K2b on the 1° graphs (phases 3 and 33): per forward (g2m + 9
    # latent + m2g) and per train step.
    lat_lons = cs.grid(1.0)
    mesh = get_hexmesh(2)
    bundles = {"g2m": build_grid_to_mesh_graph(np.asarray(lat_lons), mesh),
               "latent": build_latent_graph(mesh),
               "m2g": build_mesh_to_grid_graph(np.asarray(lat_lons), mesh)}
    fc_graphs = {n: DeviceGraph.from_bundle(b, "cuda", edge_sums=True) for n, b in bundles.items()}
    k1 = {n: cs.k1_case(edge_mlp, n, b, n != "m2g", gen) for n, b in bundles.items()}
    k2 = {n: cs.k2_case(fused_mlp, n, fc_graphs[n], n != "m2g", gen) for n in bundles}
    k2b = {n: cs.k2b_case(fused_mlp, n, fc_graphs[n], n != "m2g", gen) for n in bundles}
    result.update({
        "k1_ms": {n: v[1] for n, v in k1.items()},
        "k2_ms": {n: v[1] for n, v in k2.items()},
        "k2b_ms": {n: v["ms"]["kernel"] for n, v in k2b.items()},
        "k2b_backward_ms": {n: v["ms"]["backward"] for n, v in k2b.items()},
        "k1_max_abs_err": max(v[0] for v in k1.values()),
        "k2_max_abs_err": max(v[0] for v in k2.values()),
        "k2b_err": max(v["err"] for v in k2b.values()),
    })
    for key in ("k1_ms", "k2_ms", "k2b_ms", "k2b_backward_ms"):
        result[key]["per_forward_or_step"] = sum(result[key][n] * c for n, c in cs.EDGE_UPDATES.items())
    del fc_graphs, k1, k2, k2b
    torch.cuda.empty_cache()

    # The 1° forecaster: 3 requests and 3 train steps (phases 4 and 34).
    model = port.GraphWeatherForecaster(
        lat_lons, feature_dim=cs.FEATURE_DIM, aux_dim=cs.AUX_DIM, device="cuda"
    )
    model.init(torch.Generator().manual_seed(0))
    inputs = torch.randn(
        3, 1, len(lat_lons), cs.FEATURE_DIM + cs.AUX_DIM, generator=torch.Generator().manual_seed(1)
    ).to("cuda")
    result["fc_request_ms"] = [cs.timed(lambda: model(x))[1] for x in inputs]
    fc_gen = torch.Generator().manual_seed(5)
    fc_x = torch.randn(1, len(lat_lons), cs.FEATURE_DIM + cs.AUX_DIM, generator=fc_gen).to("cuda")
    fc_y = torch.randn(1, len(lat_lons), cs.FEATURE_DIM, generator=fc_gen).to("cuda")
    fc_loss = port.NormalizedMSELoss(np.ones(cs.FEATURE_DIM), lat_lons, normalize=True, device="cuda")
    before = fused_mlp.BACKWARD_LAUNCHES
    fc_step = port.make_train_step(
        model.module.parameters(), model.forward_fn(), fc_loss, port.make_optimizer(1e-3)
    )
    result["fc_step_ms"] = [cs.timed(lambda: fc_step(fc_x, fc_y))[1] for _ in range(3)]
    if fused_mlp.BACKWARD_LAUNCHES - before != 33:
        raise AssertionError("the forecaster's train steps did not run K2b 11 times each")
    del model, fc_step
    torch.cuda.empty_cache()

    # K4b on the splits-5 band layout (phase 27), then 3 banded train steps (30).
    band = DeviceGraph.from_bundle(build_graphcast_graphs(
        gc["grid_lon"], gc["grid_lat"], splits=5, num_hops=4, add_edge_features_to_khop=False,
        spatial_sort=True,
    ).khop, "cuda", banded=True, band_flash=True)
    role = {}
    if "symmetric" in inspect.signature(banded_flash.launch_backward).parameters:
        role = {"symmetric": getattr(band, "band_symmetric", False)}
    result["k4b_dkv_role"] = "symmetric" if role.get("symmetric") else "general"
    masks, block, w, n = band.band_masks, band.band_block, band.band_w, band.n_receivers
    k4a = {}
    for c in per_eval:
        _, (q, k, v) = cs.band_inputs(gen, band, c, 4, 3)
        out, lse = banded_flash._forward_cuda(q, k, v, masks, block, w, with_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = banded_flash.banded_flash_forward_reference(q, k, v, masks, block, w, with_lse=True)
        err = max((out - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
        if not err <= cs.K4_TOL:
            raise AssertionError(f"K4a c={c}: error {err} > {cs.K4_TOL}")
        k4a[c] = {"ms": cs.cuda_ms(lambda: banded_flash._forward_cuda(q, k, v, masks, block, w, False)),
                  "lse_ms": cs.cuda_ms(lambda: banded_flash._forward_cuda(q, k, v, masks, block, w, True)),
                  "err": err}
    for kind in ("ms", "lse_ms"):
        result[f"k4a_{kind}"] = {c: v[kind] for c, v in k4a.items()}
        result[f"k4a_{kind}"]["per_eval_or_step"] = sum(k4a[c][kind] * m for c, m in per_eval.items())
    result["k4a_max_abs_err"] = max(v["err"] for v in k4a.values())
    k4b = {}
    for c in per_eval:
        _, (q, k, v, dout) = cs.band_inputs(gen, band, c, 4, 4)
        out, lse = banded_flash._forward_cuda(q, k, v, masks, block, w, with_lse=True)
        want = banded_flash.banded_flash_backward_reference(q, k, v, masks, out, lse, dout, block, w)
        delta = torch.nn.functional.pad(
            (dout * out).sum(-1), (0, 0, 0, masks.shape[0] * block - n)).contiguous()
        grads = tuple(torch.empty_like(t) for t in (q, k, v))

        def kernel(mode):
            return lambda: banded_flash.launch_backward(
                mode, q, k, v, masks, lse, dout, delta, grads, block, w, **role)

        kernel(banded_flash.DQ)(), kernel(banded_flash.DKV)()
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(grads, want))
        if not err <= cs.K4_TOL:
            raise AssertionError(f"K4b c={c}: error {err} > {cs.K4_TOL}")
        k4b[c] = {"dq": cs.cuda_ms(kernel(banded_flash.DQ)), "dkv": cs.cuda_ms(kernel(banded_flash.DKV)),
                  "err": err}
    for kind in ("dq", "dkv"):
        result[f"k4b_{kind}_ms"] = {c: v[kind] for c, v in k4b.items()}
        result[f"k4b_{kind}_ms"]["per_eval_or_step"] = sum(k4b[c][kind] * m for c, m in per_eval.items())
    result["k4b_ms_per_step"] = result["k4b_dq_ms"]["per_eval_or_step"] + result["k4b_dkv_ms"]["per_eval_or_step"]
    result["k4b_max_abs_err"] = max(v["err"] for v in k4b.values())
    del band, masks, q, k, v, dout, out, lse, want, grads
    bden = port.Denoiser(**cs.GENCAST_BANDED, device="cuda")
    bden.init(torch.Generator().manual_seed(0))
    result["band_request_ms"] = [
        cs.timed(lambda: bden(x, c, sigma))[1] for x, c in zip(corrupted, prev)
    ]
    bstep = port.make_train_step(
        bden.module.parameters(), bden.forward_fn(), lambda p, t: loss(p, noise_t, t),
        port.make_optimizer(1e-4),
    )
    result["band_step_ms"] = [
        cs.timed(lambda: bstep(corrupted_t, prev_t, noise_t, target_t))[1] for _ in range(3)
    ]
    del bden, bstep
    torch.cuda.empty_cache()

    # K6 on the 768-d layer (phase 37 case a); 3 requests of the 768-d and of
    # the 128-d WeatherMesh (phases 38 and 19).
    kernel6 = (5, 7, 7)
    q, k, v, rpb = cs.natten_inputs(gen, kernel6, 8, 96)
    out = natten3d._forward_cuda(q, k, v, kernel6, rpb, False)
    out = out[0] if isinstance(out, tuple) else out  # (out, lse) since K6 writes lse
    torch.cuda.synchronize()
    result["k6_max_abs_err"] = (out - neighborhood_attention_3d_reference(
        q, k, v, kernel6, rpb, False)).abs().max().item()
    if not result["k6_max_abs_err"] <= cs.K5_TOL:
        raise AssertionError(f"K6: error {result['k6_max_abs_err']} > {cs.K5_TOL}")
    result["k6_ms_per_layer"] = cs.cuda_ms(lambda: natten3d._forward_cuda(q, k, v, kernel6, rpb, False))
    del q, k, v, rpb, out
    h, w = cs.WM_GRID
    levels = cs.WEATHERMESH["pressure_levels"]
    wm_gen = torch.Generator().manual_seed(1)
    surfaces = torch.randn(3, 1, h, w, 8, generator=wm_gen).to("cuda")
    pressures = torch.randn(3, 1, levels, h, w, 4, generator=wm_gen).to("cuda")
    for key, cfg in (("wm_wide_request_ms", cs.WM_WIDE), ("wm_request_ms", cs.WEATHERMESH)):
        wm = port.WeatherMesh(**cfg, device="cuda")
        wm.init(torch.Generator().manual_seed(0))
        with torch.no_grad():  # as in chip_smoke.py phase 19
            for name, t in wm.module.named_parameters():
                if name.endswith(("qkv.bias", "proj.bias")):
                    t.zero_()
        before = natten3d.LAUNCHES
        result[key] = [cs.timed(lambda: wm(s_, p_))[1] for s_, p_ in zip(surfaces, pressures)]
        result[key.replace("request_ms", "k6_launches")] = natten3d.LAUNCHES - before
        if cfg is cs.WM_WIDE and hasattr(natten3d, "launch_backward"):  # 3 train steps (phase 42)
            wide_gen = torch.Generator().manual_seed(2)
            targets = tuple(torch.randn(t.shape, generator=wide_gen).to("cuda")
                            for t in (surfaces[0], pressures[0]))
            wide_step = port.make_train_step(
                wm.module.parameters(), wm.forward_fn(),
                lambda pr, tg: ((pr.surface - tg[0]) ** 2).mean() + ((pr.pressure - tg[1]) ** 2).mean(),
                port.make_optimizer(1e-4),
            )
            before = natten3d.BWD_DKV_LAUNCHES
            torch.cuda.reset_peak_memory_stats()
            result["wm_wide_step_ms"] = [
                cs.timed(lambda: wide_step(surfaces[0], pressures[0], targets))[1] for _ in range(3)
            ]
            result["wm_wide_step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            if natten3d.BWD_DKV_LAUNCHES - before != 3 * cs.K6_PER_FORWARD:
                raise AssertionError("the wide train steps did not run K6b 16 times each")
            del wide_step
        if cfg is cs.WEATHERMESH:  # 3 train steps (phase 23)
            targets = tuple(torch.randn(t.shape, generator=wm_gen).to("cuda")
                            for t in (surfaces[0], pressures[0]))
            wm_step = port.make_train_step(
                wm.module.parameters(), wm.forward_fn(),
                lambda pr, tg: ((pr.surface - tg[0]) ** 2).mean() + ((pr.pressure - tg[1]) ** 2).mean(),
                port.make_optimizer(1e-4),
            )
            before = natten_flash.BWD_DQ_LAUNCHES
            result["wm_step_ms"] = [
                cs.timed(lambda: wm_step(surfaces[0], pressures[0], targets))[1] for _ in range(3)
            ]
            if natten_flash.BWD_DQ_LAUNCHES - before != 3 * cs.K5_PER_FORWARD:
                raise AssertionError("the WeatherMesh train steps did not run K5b 8 times each")
            del wm_step
        del wm
        torch.cuda.empty_cache()
    result.update(k5a_cases(cs, natten_flash, gen))
    result.update(k5a_on_wide_heads(cs, natten_flash, natten3d, gen))
    result.update(k6b_split(cs, natten3d, natten_flash, gen))
    result.update(k5b_split(cs, natten_flash, gen))
    for key in ("gencast_request_ms", "gencast_step_ms", "fc_request_ms", "fc_step_ms",
                "band_request_ms", "band_step_ms", "wm_wide_request_ms", "wm_request_ms",
                "wm_step_ms", "wm_wide_step_ms"):
        if key in result:
            result[key + "_median_later"] = statistics.median(result[key][1:])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
