"""Stage-2 (anchors -> chain -> align -> refine) vs the reference binary."""

import numpy as np
import pytest

from sedef_tpu.io.bed import Hit, SeqRef
from sedef_tpu.models.aligner import fast_align
from sedef_tpu.ops.anchors import generate_anchors
from sedef_tpu.ops.wavefront import WavefrontAligner


def _load(path):
    lines = path.read_text().splitlines()
    out = []
    i = 0
    while i < len(lines):
        tag, pi, qlen, rlen, nhits = lines[i].split()
        assert tag == "PAIR"
        q, r = lines[i + 1], lines[i + 2]
        i += 3
        hits = []
        for _ in range(int(nhits)):
            parts = lines[i].split()
            assert parts[0] == "HIT"
            hits.append((int(parts[1]), int(parts[2]), int(parts[3]),
                         int(parts[4]), parts[5] if len(parts) > 5 else ""))
            i += 1
        out.append((q, r, hits))
    return out


def brute_anchors(q, r, k):
    """Independent O(n*m) anchor oracle for small inputs (no posting cap)."""
    def isn(c):
        return c.upper() == "N"
    anchors = []
    slide = {}
    for qi in range(len(q) - k + 1):
        if any(isn(c) for c in q[qi:qi + k]):
            continue
        for ri in range(len(r) - k + 1):
            if any(isn(c) for c in r[ri:ri + k]):
                continue
            if q[qi:qi + k].upper() != r[ri:ri + k].upper():
                continue
            d = ri - qi
            if qi < slide.get(d, 0) and slide.get(d) is not None \
                    and qi < slide[d]:
                continue
            if d in slide and qi < slide[d]:
                continue
            ln = 0
            while (qi + ln < len(q) and ri + ln < len(r)
                   and not isn(q[qi + ln]) and not isn(r[ri + ln])
                   and q[qi + ln].upper() == r[ri + ln].upper()):
                ln += 1
            if ln >= k:
                anchors.append((qi, ri, ln))
                slide[d] = qi + ln
    anchors.sort()
    return anchors


def test_anchors_match_bruteforce():
    rng = np.random.default_rng(7)
    chars = np.array(list("ACGTacgtN"))
    probs = np.array([.2, .2, .2, .2, .04, .04, .04, .04, .04])
    q = "".join(rng.choice(chars, 300, p=probs))
    r = q[:150] + "".join(rng.choice(chars, 150, p=probs))
    got = generate_anchors(q, r, False, 0, 0, 11)
    expect = brute_anchors(q, r, 11)
    assert [(a.q, a.r, a.l) for a in got] == expect


@pytest.mark.parametrize("name", ["fast_align_1", "fast_align_2",
                                  "fast_align_3"])
def test_fast_align_matches_reference(fixtures_dir, name):
    pairs = _load(fixtures_dir / f"{name}.txt")
    al = WavefrontAligner(use_device=False)
    for q, r, expect in pairs:
        orig = Hit(SeqRef("A", False, len(q)), 0, len(q),
                   SeqRef("B", False, len(r)), 0, len(r))
        hits = fast_align(q, r, orig, 11, aligner=al)
        got = [(h.query_start, h.query_end, h.ref_start, h.ref_end,
                h.aln.cigar_string()) for h in hits]
        assert got == expect


def test_trim_front_sentinel_collision_quirk():
    """align.cc:345 initializes trim_front's "trim everything" sentinel to
    max_i = a.size(), but max_i stores a GAPPED column index — when the
    optimal cut lands exactly at column a.size() the reference discards a
    positive-scoring suffix.  Verified against an instrumented build of
    the reference trim_front on real data (a 100 Mbp ref-diff divergence
    was exactly this); we reproduce the quirk bit-for-bit."""
    from sedef_tpu.ops.cigar import Alignment

    # 20 a-chars; dropping 14 mismatch-M columns + 6 I columns = 20
    # dropped columns == len(a): the 6M match suffix (+30) starts exactly
    # at gapped column 20 -> the reference (and we) trim EVERYTHING.
    a = "A" * 14 + "C" * 6
    b = "G" * 14 + "T" * 6 + "C" * 6
    aln = Alignment.from_cigar(a, b, "14M6I6M")
    aln.trim_front()
    assert aln.cigar == [] and aln.start_a == aln.end_a

    # control: a 5-wide I run -> cut at column 17 != len(a2) = 18, the
    # suffix survives
    a2 = "A" * 12 + "C" * 6
    b2 = "G" * 12 + "T" * 5 + "C" * 6
    aln2 = Alignment.from_cigar(a2, b2, "12M5I6M")
    aln2.trim_front()
    assert aln2.cigar == [("M", 6)]
    assert aln2.end_a - aln2.start_a == 6
