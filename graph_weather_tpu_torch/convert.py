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
