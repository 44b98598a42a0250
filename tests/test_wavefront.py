"""Wavefront aligner vs the real ksw2 extz2_sse kernel (fixtures), and the
device route (plain JAX fill + traceback on the CPU backend) and its
wrapper vs the NumPy reference."""

import numpy as np
import pytest

from sedef_tpu.ops.wavefront import (DEVICE_MAX_CLASS, WILDCARD,
                                     WavefrontAligner, _pad_to_class,
                                     backtrack_np, cigar_from_packed_ops,
                                     class_parts, gap_dp_packed,
                                     pack_class_batch, wavefront_cigar_scan,
                                     wavefront_np, wavefront_scan_batch)


def _load_pairs(path):
    lines = path.read_text().splitlines()
    out = []
    i = 0
    while i < len(lines):
        tag, qlen, tlen, score = lines[i].split()
        assert tag == "PAIR"
        q = np.array([int(c) for c in lines[i + 1]], dtype=np.int8)
        t = np.array([int(c) for c in lines[i + 2]], dtype=np.int8)
        out.append((q, t, int(score), lines[i + 3]))
        i += 4
    return out


def _cigar_str(cigar):
    return "".join(f"{ln}{op}" for op, ln in cigar)


def _cigar_score(cigar, q, t, match=5, mis=-4, gapo=40, gape=1):
    """Score a CIGAR under the ksw2 model (wildcard code 4 scores 0)."""
    s = 0
    qi = ti = 0
    for op, ln in cigar:
        if op == "M":
            for _ in range(ln):
                a, b = q[qi], t[ti]
                s += 0 if (a >= 4 or b >= 4) else (match if a == b else mis)
                qi += 1
                ti += 1
        else:
            s -= gapo + gape * ln
            if op == "D":
                qi += ln
            else:
                ti += ln
    assert qi == len(q) and ti == len(t), "CIGAR must consume both sequences"
    return s


@pytest.mark.parametrize("name", ["ksw2_pairs_1", "ksw2_pairs_2"])
def test_numpy_matches_ksw2(fixtures_dir, name):
    pairs = _load_pairs(fixtures_dir / f"{name}.txt")
    assert pairs
    for q, t, score, cigar_ref in pairs:
        p, sc = wavefront_np(q, t)
        cig = backtrack_np(p, len(q), len(t))
        assert sc == score, f"score {sc} != ksw2 {score}"
        assert _cigar_str(cig) == cigar_ref


def _related(rng, qlen, tlen, rate=0.12):
    """A target derived from the query: shared prefix, ~rate substitutions."""
    q = rng.integers(0, 4, qlen).astype(np.int8)
    t = np.resize(q, tlen).copy()
    m = rng.random(tlen) < rate
    t[m] = rng.integers(0, 4, int(m.sum()))
    return q, t


def _device_aligner():
    """Aligner whose align_batch sends every problem to the device route."""
    al = WavefrontAligner(use_device=True)
    al.DEVICE_BATCH_MIN = 1
    al.DEVICE_BATCH_MIN_CELLS = 0
    return al


# the name predates the port of this route from Pallas; kept so the
# test's record stays continuous
def test_pallas_interpret_matches_numpy():
    """The aligner's device path (plain JAX route on the CPU backend)
    reproduces the NumPy reference CIGARs and scores."""
    rng = np.random.default_rng(0)
    pairs = []
    for _ in range(4):
        ql, tl = rng.integers(20, 120, 2)
        pairs.append(_related(rng, int(ql), int(tl), 0.1))
    al = _device_aligner()
    got = al.align_batch(pairs)
    assert al.device_problems == len(pairs)
    for (q, t), cig in zip(pairs, got):
        p, sc = wavefront_np(q, t)
        assert cig == backtrack_np(p, len(q), len(t))
        assert _cigar_score(cig, q, t) == sc


# the name predates the port of this route from Pallas; kept so the
# test's record stays continuous
def test_pallas_direction_rows_match_numpy():
    """The plain fill's direction rows equal the NumPy reference's on the
    valid triangle of a problem parked in one row of a padded batch."""
    rng = np.random.default_rng(3)
    ql, tl = 100, 90
    q = rng.integers(0, 4, ql).astype(np.int8)
    t = rng.integers(0, 4, tl).astype(np.int8)
    S_q = S_t = 128
    qcodes = np.full((8, S_q + S_t - 1), WILDCARD, dtype=np.int32)
    qcodes[3, :ql] = q
    tpad = np.full((8, S_t), WILDCARD, dtype=np.int8)
    tpad[3, :tl] = t
    p_dev = np.asarray(wavefront_scan_batch(qcodes, tpad, S_q, S_t))[3]
    p_ref, _ = wavefront_np(q, t)
    for r in range(ql + tl - 1):
        st0, en0 = max(0, r - ql + 1), min(r, tl - 1)
        np.testing.assert_array_equal(
            p_dev[r, st0:en0 + 1], p_ref[r, st0:en0 + 1],
            err_msg=f"row {r}")


def test_chunked_strings():
    # exercise align_strings chunking with a tiny max_ksw_seq_len
    from sedef_tpu.config import Config
    cfg = Config().finalize()
    cfg.align.max_ksw_seq_len = 64
    al = WavefrontAligner(cfg=cfg, use_device=False)
    rng = np.random.default_rng(1)
    s = "".join(rng.choice(list("ACGT"), 150))
    cig = al.align_strings(s, s)
    # self-alignment in two chunks -> all M, consuming 150 each
    assert sum(ln for op, ln in cig if op != "I") == 150
    assert sum(ln for op, ln in cig if op != "D") == 150
    assert all(op == "M" for op, ln in cig)


# the name predates the port of this route from Pallas; kept so the
# test's record stays continuous
def test_device_traceback_interpret():
    """Plain fill + lax traceback: packed ops decode to the NumPy
    reference CIGARs for symmetric and asymmetric classes, lengths from
    half the class to the full class."""
    rng = np.random.default_rng(11)
    for S_q, S_t, B in [(128, 128, 16), (256, 128, 8), (128, 256, 8)]:
        probs = [_related(rng, int(rng.integers(S_q // 2, S_q + 1)),
                          int(rng.integers(S_t // 2, S_t + 1)))
                 for _ in range(B - 2)]
        ops = np.asarray(wavefront_cigar_scan(
            *pack_class_batch(probs, range(len(probs)), S_q, S_t, B),
            S_q, S_t))
        assert ops.shape == (B, -(-(S_q + S_t - 1) // 4))
        for i, (q, t) in enumerate(probs):
            p_ref, _ = wavefront_np(q, t)
            assert cigar_from_packed_ops(ops[i], len(q), len(t)) == \
                backtrack_np(p_ref, len(q), len(t)), (S_q, S_t, i)


@pytest.mark.parametrize("S_q,S_t", [
    (128, 128), (256, 256), (512, 512), (1024, 1024), (2048, 2048),
    (128, 256), (512, 128)])
def test_device_route_matches_reference(fixtures_dir, S_q, S_t):
    """The plain device route at each size class (two asymmetric) vs
    wavefront_np + backtrack_np, and vs the ksw2 golden CIGARs of every
    fixture pair that fits the class."""
    rng = np.random.default_rng(S_q * 7 + S_t)
    probs = [_related(rng, int(rng.integers(S_q // 2 + 1, S_q + 1)),
                      int(rng.integers(S_t // 2 + 1, S_t + 1)))
             for _ in range(3)]
    want = []
    for q, t in probs:
        p, _ = wavefront_np(q, t)
        want.append(backtrack_np(p, len(q), len(t)))
    for name in ("ksw2_pairs_1", "ksw2_pairs_2"):
        for q, t, _, cig in _load_pairs(fixtures_dir / f"{name}.txt"):
            if len(q) <= S_q and len(t) <= S_t:
                probs.append((q, t))
                want.append(cig)
    ops = np.asarray(gap_dp_packed(
        *pack_class_batch(probs, range(len(probs)), S_q, S_t,
                          max(8, len(probs))), S_q, S_t, cuda=False))
    for i, ((q, t), w) in enumerate(zip(probs, want)):
        got = cigar_from_packed_ops(ops[i], len(q), len(t))
        assert (got if isinstance(w, list) else _cigar_str(got)) == w, i


def test_pad_to_class():
    assert [_pad_to_class(n) for n in (1, 128, 129, 1024, 2049, 8192)] == \
        [128, 128, 256, 1024, 4096, 8192]
    assert _pad_to_class(60000) == 61440 > DEVICE_MAX_CLASS


def test_pack_class_batch_padding():
    """Problems land in their rows, wildcard padded; None and trailing
    rows are 1 x 1 padding problems."""
    pairs = [(np.array([0, 1, 2], np.int8), np.array([3, 2], np.int8)),
             (np.array([1], np.int8), np.array([0, 0, 0, 0], np.int8))]
    qseq, tgt, ql, tl = pack_class_batch(pairs, [1, None, 0], 128, 128, 4)
    assert qseq.shape == (4, 128) and tgt.shape == (4, 128)
    assert qseq.dtype == tgt.dtype == np.int8
    assert list(ql) == [1, 1, 3, 1] and list(tl) == [4, 1, 2, 1]
    assert list(qseq[2, :4]) == [0, 1, 2, WILDCARD]
    assert list(tgt[0, :5]) == [0, 0, 0, 0, WILDCARD]
    assert (qseq[1] == WILDCARD).all() and (tgt[3] == WILDCARD).all()


def test_device_route_batch_composition_independent():
    """A problem's op stream does not depend on its batch neighbours or
    its row."""
    rng = np.random.default_rng(17)
    probs = [_related(rng, int(rng.integers(30, 128)),
                      int(rng.integers(30, 128))) for _ in range(6)]
    alone = np.asarray(wavefront_cigar_scan(
        *pack_class_batch(probs, [0], 128, 128, 8), 128, 128))[0]
    mixed = np.asarray(wavefront_cigar_scan(
        *pack_class_batch(probs, [3, 5, 0, 1], 128, 128, 8), 128, 128))[2]
    assert np.array_equal(alone, mixed)


def test_device_route_degenerate_lengths():
    """Empty sides never reach the device; 1-base sides do, and match
    the reference."""
    one = np.array([2], np.int8)
    seq = np.array([0, 1, 2, 3, 2], np.int8)
    empty = np.array([], np.int8)
    pairs = [(empty, seq), (seq, empty), (one, seq), (seq, one), (one, one)]
    al = _device_aligner()
    got = al.align_batch(pairs)
    assert got[0] == [("I", 5)] and got[1] == [("D", 5)]
    assert al.device_problems == 3
    for (q, t), cig in zip(pairs[2:], got[2:]):
        p, _ = wavefront_np(q, t)
        assert cig == backtrack_np(p, len(q), len(t))


def test_60kbp_chunk_routes_native(monkeypatch):
    """Problems above the largest device class (a 60 Kbp chunk) go to the
    native scalar DP; the rest of the batch still takes the device."""
    big = (np.zeros(60000, np.int8), np.zeros(59000, np.int8))
    small = (np.array([0, 1, 2, 3], np.int8), np.array([0, 1, 3], np.int8))
    al = _device_aligner()
    seen = {}

    def host(pairs, idxs, results, native):
        seen["host"] = list(idxs)
        for i in idxs:
            results[i] = [("M", 1)]

    def device(pairs, idxs, results):
        seen["device"] = list(idxs)
        for i in idxs:
            results[i] = [("M", 2)]

    monkeypatch.setattr(al, "_align_host", host)
    monkeypatch.setattr(al, "_align_device", device)
    al.align_batch([small, big, small])
    assert seen == {"host": [1], "device": [0, 2]}


def test_class_parts_caps_plain_route():
    """The plain route splits a class into calls within PLAIN_BUDGET
    (a power of two per shard); the CUDA route takes it whole."""
    from sedef_tpu.ops import wavefront as wf
    idxs = list(range(100))
    assert class_parts(idxs, 8192, 8192, cuda=True) == [idxs]
    per = wf.PLAIN_BUDGET // ((8192 + 8192 - 1) * 8192)
    parts = class_parts(idxs, 8192, 8192, cuda=False)
    assert sum(parts, []) == idxs
    assert len(parts[0]) <= per and len(parts[0]) & (len(parts[0]) - 1) == 0
    assert len(class_parts(idxs, 8192, 8192, cuda=False, n_shards=4)[0]) \
        == 4 * len(parts[0])
