"""chip_smoke.py on the CPU: it refuses to run without a GPU, and every
phase passes at a tiny size (the rehearsal of the GPU run)."""

import pytest

import chip_smoke


def test_main_exits_nonzero_without_gpu(capsys):
    rc = chip_smoke.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok": true' not in out


def test_main_multi_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main(["--multi"]) != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture(scope="module")
def workload():
    return chip_smoke.dense_workload(chip_smoke.TINY)


def _run(phase, *args):
    check = chip_smoke.Checks()
    phase(check, chip_smoke.TINY, *args)
    assert check.failed == []


def test_phase_dense(workload):
    _run(chip_smoke.phase_dense, "xla", workload)


def test_phase_grid_a():
    _run(chip_smoke.phase_grid_a)


def test_phase_mission(workload):
    _run(chip_smoke.phase_mission, workload)


def test_phase_streaming(workload):
    _run(chip_smoke.phase_streaming, "xla", workload)


def test_phase_exact():
    _run(chip_smoke.phase_exact)


def test_phase_precision():
    _run(chip_smoke.phase_precision)


def test_phase_multi(workload):
    # four of the suite's eight virtual CPU devices
    _run(chip_smoke.phase_multi, "xla", workload)


def test_close_flags_nan_pattern_and_tail():
    import numpy as np

    ok, _ = chip_smoke.close(np.array([1.0, np.nan]), np.array([1.0, 2.0]), 1e-3)
    assert not ok
    got = np.zeros(1000)
    want = np.zeros(1000)
    got[0] = 0.5  # one point over tolerance, under the hard max
    assert chip_smoke.close(got, want, 1e-3, frac=0.99, hard_max=1.0)[0]
    assert not chip_smoke.close(got, want, 1e-3, frac=0.99, hard_max=0.1)[0]
