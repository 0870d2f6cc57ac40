"""Utility-layer tests: debug/sanitizer mode and timing helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from auvtpu.utils import debug_mode, steady_state_ms, time_once_ms


def test_debug_mode_catches_nan_and_restores():
    @jax.jit
    def f(x):
        return jnp.log(x)

    with debug_mode():
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(f(jnp.asarray(-1.0, jnp.float32)))
    assert not jax.config.jax_debug_nans


def test_debug_mode_eager_disables_jit():
    seen = []

    @jax.jit
    def f(x):
        seen.append(1)  # traced once under jit; every call when disabled
        return x + 1

    f(jnp.asarray(0.0))
    n0 = len(seen)
    with debug_mode(nans=False, disable_jit=True):
        f(jnp.asarray(0.0))
        f(jnp.asarray(0.0))
    assert len(seen) >= n0 + 2
    assert not jax.config.jax_disable_jit


def test_timing_helpers_run():
    f = jax.jit(lambda x: (x * 2).sum())
    x = jnp.ones((64, 64))
    ms, out = time_once_ms(f, x)
    assert ms > 0 and float(out) == 2 * 64 * 64
    ss = steady_state_ms(f, x, iters=3, warmup=1)
    assert ss > 0


def test_warm_e2e_reads_back_every_leaf():
    from auvtpu.utils import warm_e2e_ms

    f = jax.jit(lambda x: (x + 1, x * 2))
    ms, (a, b) = warm_e2e_ms(f, jnp.ones(8), reps=2)
    assert ms > 0 and float(a[0]) == 2.0 and float(b[0]) == 2.0


@pytest.mark.parametrize("native_lib", [False, True])
def test_grid_csv_round_trip(tmp_path, monkeypatch, native_lib):
    """Matrix CSV with 'nan' gaps: the numpy path (no native library) and
    the native path write files that read back bit-exactly."""
    from auvtpu import native
    from auvtpu.io import read_grid_csv, write_grid_csv

    if native_lib and not native.available():
        pytest.skip("native library not built")
    if not native_lib:
        monkeypatch.setattr(native, "available", lambda: False)
    grid = np.random.default_rng(0).normal(-3000.0, 500.0, (7, 9))
    grid[2, 3] = grid[0, 0] = grid[6, 8] = np.nan
    path = str(tmp_path / "g.csv")
    write_grid_csv(path, grid)
    text = open(path).read()
    assert text.count("nan") == 3 and len(text.splitlines()) == 7
    back = read_grid_csv(path)
    assert back.shape == grid.shape
    np.testing.assert_array_equal(np.isnan(back), np.isnan(grid))
    m = ~np.isnan(grid)
    if native_lib:
        np.testing.assert_allclose(back[m], grid[m], rtol=1e-12)
    else:
        np.testing.assert_array_equal(back[m], grid[m])


def test_require_gpu_fails_on_cpu():
    from auvtpu.utils.device import require_gpu

    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()


def test_device_busy_reduces_a_recorded_trace(tmp_path):
    """The trace -> busy/idle reduction bench.py uses, on a CPU trace (its
    host plane stands in for the GPU's device plane)."""
    from auvtpu.utils.profiling import device_busy, trace

    f = jax.jit(lambda x: (jnp.sin(x) @ x).sum())
    x = jnp.ones((256, 256))
    jax.block_until_ready(f(x))
    with trace(str(tmp_path)):
        for _ in range(3):
            jax.block_until_ready(f(x))
    busy, window, kernels = device_busy(str(tmp_path), device="/host:CPU")
    assert 0 < busy <= window
    assert kernels and all(v >= 0 for v in kernels.values())
    with pytest.raises(ValueError, match="no plane"):
        device_busy(str(tmp_path))  # no GPU plane in a CPU trace
    with pytest.raises(FileNotFoundError):
        device_busy(str(tmp_path / "none"))
