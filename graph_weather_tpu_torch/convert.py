"""JAX-package parameters -> the port's state_dict.

The port names its submodules after the flax module names
(Encoder_0/MLP_0/TorchLinear_0, GraphProcessorBlock_i, ...) and keeps
kernels as [in, out], so the mapping is mechanical: join the tree path with
dots, and rename LayerNorm's `scale` to torch's `weight`.

    sd = from_jax_params(jax.device_get(params))   # flax tree of arrays
    model.module.load_state_dict(sd)        # a GraphWeatherForecaster
    denoiser.module.load_state_dict(from_jax_params(convert_denoiser(ref_sd)))

The GenCast modules are named the same way (GenCastEncoder_0,
CondTransformerBlock_i/GraphTransformerConv_0/TorchLinear_k,
ConditionalLayerNorm_0, ...); bias-free flax linears have no bias entry.

WeatherMesh is the exception: its port keeps the reference torch model's
names and torch-native layouts, so `weathermesh_from_jax` maps the JAX
package's {"params", "batch_stats"} onto them.

The input holds NumPy arrays (or anything np.asarray takes); no JAX needed.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def from_jax_params(params: Mapping) -> dict:
    """Flax param tree ({"params": {...}} or its inner dict, or any subtree
    of it) -> state_dict of the matching port module."""
    if set(params) == {"params"}:
        params = params["params"]
    state = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            parent = prefix[:-1].rsplit(".", 1)[-1]
            if name == "scale" and parent.startswith("LayerNorm"):
                name = "weight"
            state[f"{prefix}{name}"] = torch.from_numpy(
                np.array(value, dtype=np.float32)
            )

    walk(params, "")
    return state


def _numbered(tree: Mapping, stem: str) -> list:
    """The values of tree[f"{stem}_{i}"] for i = 0, 1, ... in order."""
    names = [k for k in tree if k.rsplit("_", 1)[0] == stem]
    return [tree[n] for n in sorted(names, key=lambda n: int(n.rsplit("_", 1)[1]))]


def _f32(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32))


def _linear_state(p: Mapping) -> dict:
    """TorchLinear [in, out] -> nn.Linear (weight [out, in])."""
    return {"weight": _f32(np.asarray(p["kernel"]).T), "bias": _f32(p["bias"])}


def _conv_state(p: Mapping) -> dict:
    """Flax Conv [*k, in, out] -> torch Conv [out, in, *k]."""
    w = np.asarray(p["kernel"])
    state = {"weight": _f32(w.transpose((w.ndim - 1, w.ndim - 2, *range(w.ndim - 2))))}
    if "bias" in p:
        state["bias"] = _f32(p["bias"])
    return state


def _wm_block_state(params: Mapping, stats: Mapping | None, identity: str) -> dict:
    """One ConvDownBlock ("downsample") or ConvUpBlock ("upsample") of the
    JAX package -> the port's block state_dict. Flax creates the identity
    conv and norm first (Conv_0, norm _0), then conv1/bn1, conv2/bn2."""
    kind = "BatchNorm" if "BatchNorm_0" in params else "GroupNorm"
    norm_stats = _numbered(stats, kind) if stats else [None] * 3
    names = ((identity, "bn_down" if identity == "downsample" else "bn_up"),
             ("conv1", "bn1"), ("conv2", "bn2"))
    state = {}
    for (c, n), conv_p, norm_p, norm_s in zip(
        names, _numbered(params, "Conv"), _numbered(params, kind), norm_stats
    ):
        state.update({f"{c}.{k}": v for k, v in _conv_state(conv_p).items()})
        state[f"{n}.weight"], state[f"{n}.bias"] = _f32(norm_p["scale"]), _f32(norm_p["bias"])
        if norm_s is not None:
            state[f"{n}.running_mean"] = _f32(norm_s["mean"])
            state[f"{n}.running_var"] = _f32(norm_s["var"])
            state[f"{n}.num_batches_tracked"] = torch.tensor(0)
    return state


def weathermesh_from_jax(variables: Mapping, num_processors: int) -> dict:
    """The JAX package's WeatherMesh variables {"params", "batch_stats"}
    (batch_stats only with norm="batch") -> the state_dict of the port's
    WeatherMeshModule. Flax conv kernels [*k, in, out] become [out, in, *k],
    TorchLinear kernels [in, out] become nn.Linear weights [out, in], norm
    `scale` becomes `weight`, and BatchNorm's mean/var become running_mean/
    running_var (with num_batches_tracked 0). The encoder's ConvDownBlock_{2i}
    is surface_path.{i} and _{2i+1} pressure_path.{i}; the decoder's
    ConvUpBlock_{2j} is pressure_path.{j} and _{2j+1} surface_path.{j}."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    state: dict = {}

    def add(prefix: str, sub: dict) -> None:
        state.update({f"{prefix}.{k}": v for k, v in sub.items()})

    def natten(prefix: str, p: Mapping) -> None:
        add(f"{prefix}.qkv", _linear_state(p["TorchLinear_0"]))
        state[f"{prefix}.rpb"] = _f32(p["rpb"])
        add(f"{prefix}.proj", _linear_state(p["TorchLinear_1"]))

    def blocks(scope: str, stem: str, paths: tuple, identity: str) -> None:
        block_stats = _numbered(stats.get(scope, {}), stem)
        for k, p in enumerate(_numbered(params[scope], stem)):
            s = block_stats[k] if block_stats else None
            add(f"{paths[k % 2]}.{k // 2}", _wm_block_state(p, s, identity))

    enc = params["WeatherMeshEncoder_0"]
    blocks("WeatherMeshEncoder_0", "ConvDownBlock",
           ("encoder.surface_path", "encoder.pressure_path"), "downsample")
    add("encoder.to_latent", _conv_state(enc["Conv_0"]))
    for i, p in enumerate(_numbered(enc, "NeighborhoodAttention3D")):
        natten(f"encoder.transformer_layers.{i}", p)

    procs = _numbered(params["processors"], "WeatherMeshProcessor")
    if len(procs) != num_processors:
        raise ValueError(f"{len(procs)} processors in the variables, expected {num_processors}")
    for p_i, proc in enumerate(procs):
        for i, p in enumerate(_numbered(proc, "NeighborhoodAttention3D")):
            natten(f"processors.{p_i}.layers.{i}", p)

    dec = params["WeatherMeshDecoder_0"]
    for i, p in enumerate(_numbered(dec, "NeighborhoodAttention3D")):
        natten(f"decoder.transformer_layers.{i}", p)
    add("decoder.split", _conv_state(dec["Conv_0"]))
    blocks("WeatherMeshDecoder_0", "ConvUpBlock",
           ("decoder.pressure_path", "decoder.surface_path"), "upsample")
    return state
