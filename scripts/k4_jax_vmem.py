"""Whether the JAX package's banded flash kernels (K4a, K4b) take heads of
c = 768 within their own VMEM budget, in f32 and bf16: each call either
runs (in the interpreter, on the CPU) or is refused by the kernels'
`_pick_group` with its byte estimate.

    JAX_PLATFORMS=cpu python scripts/k4_jax_vmem.py

One line per call; a few seconds on the CPU.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from graph_weather_tpu.ops.pallas import banded_flash as bf  # noqa: E402

N, HEADS, C, BLOCK, W = 600, 4, 768, 512, 512


def main() -> None:
    masks = np.zeros((2, BLOCK, BLOCK + 2 * W), np.int8)
    masks[0, 0, BLOCK] = 1
    masks = jnp.asarray(masks)
    for dtype in (jnp.float32, jnp.bfloat16):
        q = jnp.ones((N, HEADS, C), dtype)
        calls = {
            "forward": lambda: bf._flash_impl(q, q, q, masks, BLOCK, W, True),
            "forward with lse": lambda: bf._flash_impl(q, q, q, masks, BLOCK, W, True, with_lse=True),
            "backward": lambda: bf._flash_bwd_impl(
                q, q, q, masks, *bf._flash_impl(q, q, q, masks, BLOCK, W, True, with_lse=True),
                q, BLOCK, W, True),
        }
        for name, call in calls.items():
            try:
                jax.block_until_ready(call())
                print(f"{dtype.__name__} {name} at c = {C}: runs")
            except ValueError as err:
                print(f"{dtype.__name__} {name} at c = {C}: refused ({str(err).split(';')[0]})")


if __name__ == "__main__":
    main()
