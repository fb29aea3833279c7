"""The one place that decides how a Pallas kernel runs.

Every ``pl.pallas_call`` in the package takes its keyword arguments from
``pallas_route``:

- on ``gpu`` the kernel is compiled through Pallas' Triton route;
- on ``cpu`` it runs in the Pallas interpreter — that exists for the CPU
  test suite and the CPU CLI recipe, never as a fallback on an accelerator;
- any other platform is an error.
"""

from __future__ import annotations

import jax
from jax.experimental.pallas import triton as plt


def _platform() -> str:
    return jax.devices()[0].platform


def pallas_route(num_warps: int = 4) -> dict:
    """``pallas_call`` keyword arguments for the default device's platform."""
    platform = _platform()
    if platform == "gpu":
        return dict(
            backend="triton", compiler_params=plt.CompilerParams(num_warps=num_warps)
        )
    if platform == "cpu":
        return dict(backend="triton", interpret=True)
    raise RuntimeError(
        f"no Pallas kernel route for platform {platform!r}: the renderer runs "
        "its kernels compiled on a CUDA GPU, or interpreted on the CPU"
    )
