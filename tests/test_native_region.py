"""Native full-region align path (sedef_fast_align) parity.

The dense-SD regime fix (docs/HG19_DENSE.md) moves the whole per-region
stage-2b path — anchors -> chaining -> guided assembly -> refinement —
into native code.  These tests pin it against the Python path
(models/aligner.py + ops/cigar.py), which is itself golden-fixtured
against the compiled reference: identical hits, CIGARs, and BED-level
error stats on simulated SDs across the error spectrum, including
rc mates, N runs, and soft-masked (lowercase) stretches.
"""

import random

import pytest

from sedef_tpu.io.bed import Hit, SeqRef
from sedef_tpu.models import simulate
from sedef_tpu.models.aligner import fast_align
from sedef_tpu.ops.wavefront import WavefrontAligner

try:
    from sedef_tpu.native import lib as native
    HAVE = native.has("fast_align")
except Exception:  # pragma: no cover
    HAVE = False

pytestmark = pytest.mark.skipif(not HAVE, reason="native lib not built")


def _mutate(rng: random.Random, seq: str, error: int, big: int = 0) -> str:
    out = simulate.make_small(rng, seq, error)
    if big:
        out = simulate.make_large(rng, out, big)
    return out


def _mask_case_and_n(rng: random.Random, seq: str) -> str:
    """Random lowercase stretches + an occasional N run."""
    s = list(seq)
    i = 0
    while i < len(s):
        if rng.random() < 0.02:
            ln = rng.randint(20, 300)
            for j in range(i, min(len(s), i + ln)):
                s[j] = s[j].lower()
            i += ln
        elif rng.random() < 0.004:
            ln = rng.randint(5, 150)
            for j in range(i, min(len(s), i + ln)):
                s[j] = "N"
            i += ln
        else:
            i += 1
    return "".join(s)


def _rows(hits, orig):
    out = []
    for hh in hits:
        out.append((hh.query_start, hh.query_end, hh.ref_start, hh.ref_end,
                    hh.aln.cigar_string(), hh.aln.matches(),
                    hh.aln.mismatches(), hh.aln.gap_bases(),
                    f"{hh.aln.total_error():.1f}",
                    f"m={hh.aln.mismatch_error():.1f};"
                    f"g={hh.aln.gap_error():.1f}",
                    hh.aln.span()))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_native_region_matches_python_path(monkeypatch, seed):
    rng = random.Random(seed)
    al = WavefrontAligner(use_device=False)
    cases = []
    for i in range(12):
        n = rng.randint(900, 6000)
        q = simulate.rand_seq(rng, n)
        err = rng.choice([0, 2, 5, 10, 15, 20, 25, 30])
        big = rng.choice([0, 0, 500, 2000])
        r = _mutate(rng, q, err, big)
        if i % 3 == 0:
            q = _mask_case_and_n(rng, q)
            r = _mask_case_and_n(rng, r)
        # flanks so side extensions have material to chew on
        q = simulate.rand_seq(rng, 400) + q + simulate.rand_seq(rng, 400)
        r = simulate.rand_seq(rng, 400) + r + simulate.rand_seq(rng, 400)
        same_chr = i % 4 == 0
        cases.append((q, r, same_chr))

    for q, r, same_chr in cases:
        name_r = "A" if same_chr else "B"
        orig = Hit(SeqRef("A", False, len(q)), 0, len(q),
                   SeqRef(name_r, False, len(r)), 100 if same_chr else 0,
                   100 + len(r) if same_chr else len(r))
        monkeypatch.setenv("SEDEF_NATIVE_REGION", "0")
        py = _rows(fast_align(q, r, orig, 11, aligner=al), orig)
        monkeypatch.setenv("SEDEF_NATIVE_REGION", "1")
        nat = _rows(fast_align(q, r, orig, 11, aligner=al), orig)
        assert nat == py


def test_native_region_gate_engages_by_default():
    """On a CPU backend the gate must be on, and the returned hits carry
    AlnStats (the native path ran, not the Python one)."""
    from sedef_tpu.models.aligner import _native_region_gate
    from sedef_tpu.ops.cigar import AlnStats

    assert _native_region_gate("A" * 1000, "A" * 1000)
    rng = random.Random(7)
    q = simulate.rand_seq(rng, 1500)
    r = _mutate(rng, q, 5)
    orig = Hit(SeqRef("A", False, len(q)), 0, len(q),
               SeqRef("B", False, len(r)), 0, len(r))
    hits = fast_align(q, r, orig, 11)
    assert hits and all(isinstance(h.aln, AlnStats) for h in hits)
