"""auvtpu — accelerator-native real-time bathymetry interpolation framework.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
devsaxena974/AUV-Real-Time-Interpolation (CPU C++ + CUDA study of bilinear /
bicubic / ordinary-kriging interpolation for AUV deep-sea mapping):

- :mod:`auvtpu.grid`      — device-resident regular grid (mask, not NaN)
- :mod:`auvtpu.ops`       — XLA/Pallas interpolation ops (scattered + dense)
- :mod:`auvtpu.golden`    — float64 host oracle, bit-matched to the reference
- :mod:`auvtpu.metrics`   — reference-biased and corrected error metrics
- :mod:`auvtpu.masking`   — seeded fault-injection masking pipeline
- :mod:`auvtpu.synthetic` — closed-form synthetic bathymetry
- :mod:`auvtpu.io`        — GEBCO netCDF + reference-schema CSVs
- :mod:`auvtpu.parallel`  — mesh/sharding (query DP, spatial grid sharding)
- :mod:`auvtpu.scattered` — scattered-data -> grid pipelines (matmul kNN)
- :mod:`auvtpu.learned`   — learned inpainting baseline (flax CNN)
- :mod:`auvtpu.serve`     — AOT export/serving (StableHLO artifacts, jax.export)
- :mod:`auvtpu.cli`       — benchmark/demo entry points (the 4 executables)
"""

__version__ = "0.1.0"

import os as _os

# Persistent compilation cache at a fixed in-checkout path, so every process
# after the first skips recompiling.  Where JAX_COMPILATION_CACHE_DIR is set,
# JAX uses that directory and nothing is set here; JAX_COMPILATION_CACHE_DIR=""
# opts out.
if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    import jax as _jax

    # key the cache dir by the PREFERRED platform (the head of the priority
    # list): XLA:CPU entries embed compile-host machine features and must not
    # be reloaded by an accelerator process, or vice versa
    _plat = str(_jax.config.jax_platforms or _os.environ.get("JAX_PLATFORMS", ""))
    _suffix = "_cpu" if _plat.split(",")[0].strip() == "cpu" else ""
    _cache = _os.path.join(_os.path.dirname(__file__), "..", f".jax_cache{_suffix}")
    _jax.config.update("jax_compilation_cache_dir", _os.path.abspath(_cache))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .config import EngineConfig, Extent, FallbackConfig, IDWConfig, KrigingConfig, VariogramConfig
from .grid import RegularGrid

__all__ = [
    "EngineConfig",
    "Extent",
    "FallbackConfig",
    "IDWConfig",
    "KrigingConfig",
    "VariogramConfig",
    "RegularGrid",
    "__version__",
]
