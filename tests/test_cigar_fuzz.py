"""Property-based fuzz of the CIGAR surgery (ops/cigar.py).

The golden fixtures pin specific reference cases; this fuzz sweeps random
mutated pairs through the same surgery the align stage performs —
from_seqs, trim_front/trim_back, merge, from_cigar round trips — and
asserts the structural invariants that every Alignment must keep:

* CIGAR consumption equals the coordinate spans (M+D consumes ``a``,
  M+I consumes ``b`` — this module's gap convention, see
  _append_gap_cigar);
* gapped strings reproduce the raw substrings when de-gapped;
* op lengths stay positive;
* trims only ever shrink the span (monotonic coordinates).
"""

import numpy as np

from sedef_tpu.config import DEFAULT
from sedef_tpu.ops.cigar import Alignment
from sedef_tpu.ops.wavefront import WavefrontAligner

AL = WavefrontAligner(use_device=False)


def mutate(s: str, rate: float, rng) -> str:
    out = []
    for ch in s:
        u = rng.random()
        if u < rate * 0.6:
            out.append("ACGT"[rng.integers(4)])
        elif u < rate * 0.8:
            continue  # deletion
        elif u < rate:
            out.append(ch)
            out.append("ACGT"[rng.integers(4)])  # insertion
        else:
            out.append(ch)
    return "".join(out)


def rand_pair(rng, n=2600, rate=0.12):
    q = "".join(rng.choice(list("ACGT"), n))
    return q, mutate(q, rate, rng)


def check_consistent(al: Alignment, tag: str) -> None:
    qspan = al.end_a - al.start_a
    rspan = al.end_b - al.start_b
    mq = sum(n for op, n in al.cigar if op in "MD")
    mr = sum(n for op, n in al.cigar if op in "MI")
    assert (mq, mr) == (qspan, rspan), (tag, mq, qspan, mr, rspan)
    # zero-length ops exist only as reference quirks: the '\0' sentinel an
    # empty-alignment cigar_from_alignment leaves behind (align.cc:501) and
    # the big-gap ma-mi==0 I/D filler (align.cc:137); both are invisible in
    # cigar_string but must stay in the op list to block junction coalescing.
    assert all(n > 0 or op in "\x00ID" for op, n in al.cigar), (tag, al.cigar)
    assert len(al.a) == qspan and len(al.b) == rspan, tag
    assert al.align_a.replace("-", "") == al.a, tag
    assert al.align_b.replace("-", "") == al.b, tag
    assert len(al.align_a) == len(al.align_b) == len(al.alignment), tag
    # reference semantics: errors are percentages (align.cc error())
    assert 0 <= al.total_error() <= 100.0 or al.span() == 0, tag


def test_fuzz_trims():
    for seed in range(12):
        rng = np.random.default_rng(seed)
        q, r = rand_pair(rng, rate=0.05 + 0.025 * (seed % 8))
        al = Alignment.from_seqs(q, r, AL)
        check_consistent(al, f"from_seqs[{seed}]")
        f = al.copy()
        f.trim_front(DEFAULT)
        check_consistent(f, f"trim_front[{seed}]")
        assert f.start_a >= al.start_a and f.start_b >= al.start_b
        assert f.end_a == al.end_a and f.end_b == al.end_b
        b = al.copy()
        b.trim_back(DEFAULT)
        check_consistent(b, f"trim_back[{seed}]")
        assert b.end_a <= al.end_a and b.end_b <= al.end_b
        assert b.start_a == al.start_a and b.start_b == al.start_b
        # both trims compose
        fb = f
        fb.trim_back(DEFAULT)
        check_consistent(fb, f"trim_both[{seed}]")


def test_fuzz_cigar_roundtrip():
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        q, r = rand_pair(rng, n=1500)
        al = Alignment.from_seqs(q, r, AL)
        rt = Alignment.from_cigar(al.a, al.b, al.cigar_string())
        assert rt.cigar == al.cigar
        assert rt.align_a == al.align_a
        assert rt.align_b == al.align_b
        assert (rt.matches(), rt.mismatches(), rt.gaps(), rt.gap_bases()) \
            == (al.matches(), al.mismatches(), al.gaps(), al.gap_bases())


def test_fuzz_merge():
    """Overlapping block merge: absolute coordinates, de-gap identity and
    full-span coverage must survive the double cut + gap re-alignment."""
    for seed in range(10):
        rng = np.random.default_rng(200 + seed)
        q, r = rand_pair(rng, n=3400, rate=0.04 + 0.02 * (seed % 4))
        cut_q = 1700 + int(rng.integers(-200, 200))
        cut_r = min(cut_q + int(rng.integers(-60, 60)), len(r) - 400)
        ov = int(rng.integers(40, 400))
        first = Alignment.from_seqs(q[:cut_q], r[:cut_r], AL)
        cur = Alignment.from_seqs(q[cut_q - ov:], r[cut_r - ov:], AL)
        cur.start_a += cut_q - ov
        cur.end_a += cut_q - ov
        cur.start_b += cut_r - ov
        cur.end_b += cut_r - ov
        assert cur.start_a < first.end_a  # genuine overlap
        first.merge(cur, q, r, AL)
        check_consistent(first, f"merge[{seed}]")
        assert first.start_a == 0 and first.start_b == 0
        assert first.end_a == len(q) and first.end_b == len(r)
        assert first.a == q and first.b == r

def test_empty_rebuild_sentinel_blocks_coalescing():
    """align.cc:501 quirk: cigar_from_alignment on an empty alignment pushes
    the initial {'\\0', 0} run.  The sentinel never prints, but it sits in
    the op deque and blocks append_cigar's junction merge — the reference
    emits '58M62M' instead of '120M' when a fully-trimmed mate is merged."""
    al = Alignment()
    al.cigar_from_alignment()
    assert al.cigar == [("\x00", 0)]

    left = Alignment.from_cigar("A" * 58, "A" * 58, "58M")
    left.append_cigar(al.cigar)
    left.append_cigar([("M", 62)])
    assert left.cigar == [("M", 58), ("\x00", 0), ("M", 62)]
    assert left.cigar_string() == "58M62M"
    # the sentinel counts as a gap *run* with zero bases (align.cc:300-304)
    left.a = "A" * 120
    left.b = "A" * 120
    left.populate()
    assert left.gaps() == 1 and left.gap_bases() == 0


def test_pretty_render():
    """pretty() (align.cc:638-677) renders header + width-wrapped blocks."""
    al = Alignment.from_cigar("ACGTACGTAA", "ACCTACGT", "4M2D4M")
    s = al.pretty(width=6)
    lines = s.splitlines()
    assert lines[2].startswith("   CIGAR: 4M2D4M")
    assert "ACGTAC" in lines[3] and "ACCT--" in lines[5]
    only = al.pretty(width=-1, only_alignment=True)
    assert only.splitlines()[0] == "ACGTACGTAA"
    assert only.splitlines()[2] == "ACCT--ACGT"


# ---------------------------------------------------------------------------
# Live reference-oracle fuzz (VERDICT r3 #8): random alignments through
# trim_front / trim_back / trim / merge, byte-compared against the
# REFERENCE surgery compiled from /root/reference sources
# (tools/oracles/cigar_oracle.cc).  >= 200 cases per run.
# ---------------------------------------------------------------------------

import pathlib
import subprocess

import pytest

_ORACLE = "/tmp/sedef_cigar_oracle"
_REF = "/root/reference"


@pytest.fixture(scope="session")
def cigar_oracle():
    if not pathlib.Path(_REF).exists():  # pragma: no cover
        pytest.skip("reference sources not mounted")
    if not pathlib.Path(_ORACLE).exists():
        oracles = (pathlib.Path(__file__).resolve().parent.parent
                   / "tools" / "oracles")
        cmd = ["g++", "-std=c++14", "-O2", "-msse4.1", "-include",
               "algorithm", f"-I{_REF}/src", f"-I{_REF}",
               f"-I{oracles}/fakeboost", str(oracles / "cigar_oracle.cc"),
               f"{_REF}/src/align.cc", f"{_REF}/src/hit.cc",
               f"{_REF}/src/hash.cc", f"{_REF}/src/fasta.cc",
               f"{_REF}/src/globals.cc", f"{_REF}/extern/format.cc",
               f"{_REF}/extern/ksw2_extz2_sse.cc", "-o", _ORACLE]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:  # pragma: no cover
            pytest.skip(f"oracle build failed: {r.stderr[-300:]}")
    return _ORACLE


def _ours_line(al: Alignment) -> str:
    cig = al.cigar_string()
    return (f"{al.start_a} {al.end_a} {al.start_b} {al.end_b} "
            f"{cig if cig else '.'}")


def test_fuzz_surgery_vs_reference_oracle(cigar_oracle):
    """>= 200 random trim/merge cases, exact coordinate + CIGAR equality
    with the reference implementation."""
    rng = np.random.default_rng(42)
    cases: list[str] = []
    expect: list[str] = []

    # 180 trim cases (60 alignments x TRIMF/TRIMB/TRIM)
    for i in range(60):
        n = int(rng.integers(400, 1200))
        rate = 0.03 + 0.17 * (i % 7) / 6
        q = "".join(rng.choice(list("ACGT"), n))
        r = mutate(q, rate, rng)
        base = Alignment.from_seqs(q, r, AL)
        cig = base.cigar_string()
        for mode, op in (("TRIMF", "trim_front"), ("TRIMB", "trim_back"),
                         ("TRIM", "trim")):
            al = Alignment.from_cigar(q, r, cig)
            getattr(al, op)() if mode == "TRIM" else getattr(al, op)(DEFAULT)
            cases.append(f"{mode} {q} {r} {cig}")
            expect.append(_ours_line(al))

    # 60 merge cases
    merges = 0
    while merges < 60:
        n = int(rng.integers(1600, 2600))
        q = "".join(rng.choice(list("ACGT"), n))
        r = mutate(q, 0.03 + 0.05 * (merges % 3), rng)
        cut_q = n // 2 + int(rng.integers(-150, 150))
        cut_r = min(cut_q + int(rng.integers(-40, 40)), len(r) - 300)
        ov = int(rng.integers(40, 300))
        if cut_r - ov <= 0:
            continue
        first = Alignment.from_seqs(q[:cut_q], r[:cut_r], AL)
        cur = Alignment.from_seqs(q[cut_q - ov:], r[cut_r - ov:], AL)
        cig1, cig2 = first.cigar_string(), cur.cigar_string()
        cur.start_a += cut_q - ov
        cur.end_a += cut_q - ov
        cur.start_b += cut_r - ov
        cur.end_b += cut_r - ov
        if not (cur.start_a < first.end_a or cur.start_b < first.end_b):
            continue
        cases.append(
            f"MERGE {q} {r} 0 {cut_q} 0 {cut_r} {cig1} "
            f"{cur.start_a} {cur.end_a} {cur.start_b} {cur.end_b} {cig2}")
        first.merge(cur, q, r, AL)
        check_consistent(first, f"oracle_merge[{merges}]")
        expect.append(_ours_line(first))
        merges += 1

    assert len(cases) >= 200
    out = subprocess.run([cigar_oracle], input="\n".join(cases) + "\n",
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-300:]
    got = out.stdout.splitlines()
    assert len(got) == len(cases)
    bad = [(cases[i][:60], got[i], expect[i])
           for i in range(len(cases)) if got[i] != expect[i]]
    assert not bad, f"{len(bad)} divergences; first: {bad[0]}"
