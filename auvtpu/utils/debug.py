"""Debug / sanitizer mode (SURVEY.md §5 'Race detection / sanitizers').

The reference's closest artifacts are the CUDA `-g -G` debug build flags
(CMakeLists.txt:7) and a tid-0 printf inside the kriging kernel
(kernels.cu:469-476).  The equivalent here is a process-wide checking
mode:

- ``jax_debug_nans``: every jitted computation re-runs op-by-op when a NaN
  appears in an output and raises at the producing primitive — the moral
  equivalent of compute-sanitizer for the "0*NaN poisons a one-hot select"
  class of bug this project has actually hit (CLAUDE.md Mosaic notes);
- ``jax_disable_jit``: runs everything op-by-op under eager dispatch so
  Python breakpoints/prints land inside 'kernels';
- optionally x64, since bugs that vanish in f64 are precision bugs.

Use as a context manager or process-wide::

    with debug_mode():                  # NaN checking only
        out = fill_kriging(grid)
    with debug_mode(disable_jit=True):  # step-through mode
        ...

CLIs expose it as ``--debug`` (NaN checking) / ``--debug-eager``.

NaN caveat: ops that *legitimately* produce NaN (the reference encodes
"no data" as NaN) will trip the checker at their final ``jnp.where``; run
debug mode on workloads with full coverage, or catch the FloatingPointError
and inspect the reported primitive.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def debug_mode(*, nans: bool = True, disable_jit: bool = False, x64: bool = False):
    """Context manager enabling JAX's checking modes; restores on exit."""
    old = {
        "jax_debug_nans": jax.config.jax_debug_nans,
        "jax_disable_jit": jax.config.jax_disable_jit,
        "jax_enable_x64": jax.config.jax_enable_x64,
    }
    try:
        if nans:
            jax.config.update("jax_debug_nans", True)
        if disable_jit:
            jax.config.update("jax_disable_jit", True)
        if x64:
            jax.config.update("jax_enable_x64", True)
        yield
    finally:
        for k, v in old.items():
            jax.config.update(k, v)


def enable_debug(*, nans: bool = True, disable_jit: bool = False) -> None:
    """Process-wide switch (CLI ``--debug`` / ``--debug-eager``)."""
    if nans:
        jax.config.update("jax_debug_nans", True)
    if disable_jit:
        jax.config.update("jax_disable_jit", True)
