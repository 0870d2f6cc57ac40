"""Device checks for entry points that measure the accelerator."""

from __future__ import annotations

import subprocess


def require_gpu():
    """Return jax.devices() if the first device is a GPU; raise SystemExit
    otherwise.  A measurement path never falls back to the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: jax.devices()[0] is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this entry point measures the GPU"
        )
    return devs


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, or
    'not available' where nvidia-smi cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "not available"
