"""Self-calibrating device/host dispatch policy.

The reference adapts to its host once, at build time (``-march=native``
+ the SSE banner, main.cc:112-123).  This engine's equivalent decisions
are runtime ones — whether a given piece of work is worth a device
dispatch — and their breakevens are taken as linear in the *dispatch
latency*.  This module measures dispatch latency once per process and
derives the thresholds from it, scaled from a set of anchors.

The anchors below are NOT measured on this card: they are the values an
earlier platform used at a 30 ms dispatch latency.  Measuring them on the
H100 (native scalar DP vs the device batch per size class) is ROADMAP S3;
until then the derived values are a starting point, not a breakeven.

Derived knobs:

* ``prefilter_min_steps`` — planned host-roll steps below which a
  chromosome pair skips the device roll prefilter (host roll time
  against the dispatch overhead).
* ``prefilter_on`` — default-on only when dispatch <= 2 ms (a local
  device, where the device bound overlaps the host rolls).
* ``device_batch_min_cells`` / ``device_batch_min`` — minimum DP work
  and batch size to route gap alignments through the device kernel
  instead of the native scalar.

Explicit env overrides always win over calibration (SEDEF_PREFILTER,
SEDEF_PREFILTER_MIN_STEPS, SEDEF_DEVICE_BATCH_MIN_CELLS).
``SEDEF_DISPATCH_MS`` injects a dispatch latency without measuring
(tests + simulated backends); ``SEDEF_NO_CALIBRATE=1`` keeps the anchor
values.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

# ---- anchors (not measured on this card; ROADMAP S3) -----------------
ANCHOR_DISPATCH_MS = 30.0
ANCHOR_PREFILTER_MIN_STEPS = 1 << 20
ANCHOR_BATCH_MIN_CELLS = 1 << 25
ANCHOR_BATCH_MIN = 256
PREFILTER_LOCAL_DISPATCH_MS = 2.0     # "device is local" threshold


@dataclass
class Calibration:
    dispatch_ms: float
    measured: bool                      # False when injected/defaulted
    prefilter_on: bool = False
    prefilter_min_steps: int = ANCHOR_PREFILTER_MIN_STEPS
    device_batch_min_cells: int = ANCHOR_BATCH_MIN_CELLS
    device_batch_min: int = ANCHOR_BATCH_MIN

    @classmethod
    def derive(cls, dispatch_ms: float, measured: bool) -> "Calibration":
        scale = dispatch_ms / ANCHOR_DISPATCH_MS
        return cls(
            dispatch_ms=dispatch_ms,
            measured=measured,
            prefilter_on=dispatch_ms <= PREFILTER_LOCAL_DISPATCH_MS,
            # linear in dispatch: steps whose prunable host time equals
            # the overhead (~1.3x one round trip at the anchor)
            prefilter_min_steps=int(min(max(
                ANCHOR_PREFILTER_MIN_STEPS * scale, 1 << 12), 1 << 26)),
            device_batch_min_cells=int(min(max(
                ANCHOR_BATCH_MIN_CELLS * scale, 1 << 21), 1 << 26)),
            device_batch_min=int(min(max(
                ANCHOR_BATCH_MIN * scale, 8), 1024)),
        )


def measure_dispatch_ms(reps: int = 5) -> float:
    """Median wall time of a trivial jit round trip on the default
    backend (compile excluded by a warmup call)."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda v: (v * 2).sum())
    x = jnp.ones((8, 128), jnp.float32)
    float(f(x))  # compile + warm
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(f(x))
        samples.append((time.perf_counter() - t0) * 1e3)
    samples.sort()
    return samples[len(samples) // 2]


_CAL: Calibration | None = None


def get(force_remeasure: bool = False) -> Calibration:
    """Process-wide lazy calibration singleton."""
    global _CAL
    if _CAL is not None and not force_remeasure:
        return _CAL
    inj = os.environ.get("SEDEF_DISPATCH_MS", "")
    if os.environ.get("SEDEF_NO_CALIBRATE", ""):
        _CAL = Calibration(ANCHOR_DISPATCH_MS, measured=False)
    elif inj:
        _CAL = Calibration.derive(float(inj), measured=False)
    else:
        try:
            _CAL = Calibration.derive(measure_dispatch_ms(),
                                      measured=True)
        except Exception:  # pragma: no cover - no backend at all
            _CAL = Calibration(ANCHOR_DISPATCH_MS, measured=False)
    return _CAL


def apply(cal: Calibration | None = None) -> dict:
    """Install the calibrated thresholds into the policy points
    (seeder prefilter gates, WavefrontAligner batch breakevens).
    Explicit env overrides keep their values.  Returns what was set."""
    cal = cal or get()
    from .models import seeder
    from .ops.wavefront import WavefrontAligner

    applied = {"dispatch_ms": round(cal.dispatch_ms, 3),
               "measured": cal.measured}
    if "SEDEF_PREFILTER" not in os.environ:
        seeder.PREFILTER_ON = cal.prefilter_on
        applied["prefilter_on"] = cal.prefilter_on
    if "SEDEF_PREFILTER_MIN_STEPS" not in os.environ:
        seeder.PREFILTER_MIN_STEPS = cal.prefilter_min_steps
        applied["prefilter_min_steps"] = cal.prefilter_min_steps
    if "SEDEF_DEVICE_BATCH_MIN_CELLS" not in os.environ:
        WavefrontAligner.DEVICE_BATCH_MIN_CELLS = \
            cal.device_batch_min_cells
        applied["device_batch_min_cells"] = cal.device_batch_min_cells
    WavefrontAligner.DEVICE_BATCH_MIN = cal.device_batch_min
    applied["device_batch_min"] = cal.device_batch_min
    return applied
