"""Self-calibrating dispatch policy (VERDICT r4 item 3).

The calibrator must (a) reproduce the anchor thresholds when the
measured dispatch latency equals the 30 ms anchor, (b) re-enable the
stood-down device paths on a fast-dispatch backend (the CPU backend's
sub-ms dispatch stands in for a locally attached card), and (c) never
override an explicit env choice."""

import os

import pytest

from sedef_tpu import devcal
from sedef_tpu.devcal import (ANCHOR_BATCH_MIN, ANCHOR_BATCH_MIN_CELLS,
                              ANCHOR_PREFILTER_MIN_STEPS, Calibration)


def test_anchor_reproduces_r4_frozen_values():
    cal = Calibration.derive(30.0, measured=True)
    assert cal.prefilter_min_steps == ANCHOR_PREFILTER_MIN_STEPS
    assert cal.device_batch_min_cells == ANCHOR_BATCH_MIN_CELLS
    assert cal.device_batch_min == ANCHOR_BATCH_MIN
    assert cal.prefilter_on is False  # slow dispatch: stays opt-in


def test_fast_dispatch_reenables_device_paths():
    cal = Calibration.derive(0.1, measured=True)
    assert cal.prefilter_on is True
    assert cal.prefilter_min_steps < ANCHOR_PREFILTER_MIN_STEPS // 16
    assert cal.device_batch_min_cells == 1 << 21  # clamp floor
    assert cal.device_batch_min == 8


def test_scaling_is_monotone_and_clamped():
    prev = None
    for ms in (0.05, 1.0, 10.0, 30.0, 120.0, 10000.0):
        cal = Calibration.derive(ms, measured=True)
        if prev is not None:
            assert cal.prefilter_min_steps >= prev.prefilter_min_steps
            assert (cal.device_batch_min_cells
                    >= prev.device_batch_min_cells)
        prev = cal
    assert prev.device_batch_min_cells <= 1 << 26
    assert prev.device_batch_min <= 1024


def test_injected_and_disabled_modes(monkeypatch):
    monkeypatch.setattr(devcal, "_CAL", None)
    monkeypatch.setenv("SEDEF_DISPATCH_MS", "30")
    cal = devcal.get()
    assert cal.dispatch_ms == 30.0 and not cal.measured
    monkeypatch.setattr(devcal, "_CAL", None)
    monkeypatch.delenv("SEDEF_DISPATCH_MS")
    monkeypatch.setenv("SEDEF_NO_CALIBRATE", "1")
    cal = devcal.get()
    assert cal.prefilter_min_steps == ANCHOR_PREFILTER_MIN_STEPS


def test_measured_on_cpu_backend_is_fast(monkeypatch):
    """The CPU backend is the simulated fast-dispatch device: measurement
    must come in far below the 30 ms anchor and flip the policies."""
    monkeypatch.setattr(devcal, "_CAL", None)
    monkeypatch.delenv("SEDEF_DISPATCH_MS", raising=False)
    cal = devcal.get()
    assert cal.measured
    assert cal.dispatch_ms < devcal.ANCHOR_DISPATCH_MS / 3
    assert cal.prefilter_on is True


def test_apply_respects_env_overrides(monkeypatch):
    from sedef_tpu.models import seeder
    from sedef_tpu.ops.wavefront import WavefrontAligner

    old = (seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS,
           WavefrontAligner.DEVICE_BATCH_MIN_CELLS,
           WavefrontAligner.DEVICE_BATCH_MIN)
    try:
        monkeypatch.setenv("SEDEF_PREFILTER_MIN_STEPS", "777")
        seeder.PREFILTER_MIN_STEPS = 777
        applied = devcal.apply(Calibration.derive(0.1, measured=True))
        assert "prefilter_min_steps" not in applied
        assert seeder.PREFILTER_MIN_STEPS == 777
        assert seeder.PREFILTER_ON is True  # no explicit env for it
        assert WavefrontAligner.DEVICE_BATCH_MIN == 8
        monkeypatch.delenv("SEDEF_PREFILTER_MIN_STEPS")
        applied = devcal.apply(Calibration.derive(30.0, measured=True))
        assert applied["prefilter_min_steps"] == \
            ANCHOR_PREFILTER_MIN_STEPS
        assert seeder.PREFILTER_ON is False
    finally:
        (seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS,
         WavefrontAligner.DEVICE_BATCH_MIN_CELLS,
         WavefrontAligner.DEVICE_BATCH_MIN) = old
