"""The one place that maps a platform and dtype to a dense-fill backend.

Backends:
- ``"xla"``   — the whole-plane pipelines of ops.dense, every platform and
  dtype;
- ``"fused"`` — the fused kriging fill kernel (pallas/kriging_fill.py,
  Pallas on the Triton route), GPU and float32 only.  It fuses the kriging
  fill; the idw and mean fills run the XLA pipelines under either backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def resolve(platform: str, dtype) -> str:
    """Backend for ``platform`` (``jax.Device.platform``) and grid dtype.

    gpu + float32 -> "fused"; gpu + float64 -> "xla"; cpu -> "xla".  Any
    other platform raises ValueError: nothing here is tuned for it."""
    if platform == "gpu":
        return "fused" if jnp.dtype(dtype) == jnp.float32 else "xla"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no dense-fill backend for platform {platform!r}")


def pick(backend: str, dtype) -> str:
    """An explicit backend passes through; "auto" resolves for the platform
    of jax.devices()[0]."""
    if backend == "auto":
        return resolve(jax.devices()[0].platform, dtype)
    if backend not in ("xla", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend
