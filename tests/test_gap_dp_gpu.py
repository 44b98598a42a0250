"""The CUDA gap-DP kernel on the card (marked ``gpu``: skipped without a
GPU; ``python chip_smoke.py`` runs these in its phase A).  The kernel has
no interpret mode; its arithmetic is pinned here against the plain JAX
route and the NumPy reference."""

import numpy as np
import pytest

from sedef_tpu.ops.wavefront import (WavefrontAligner, backtrack_np,
                                     cigar_from_packed_ops, gap_dp_packed,
                                     pack_class_batch, wavefront_cigar_scan,
                                     wavefront_np)

pytestmark = pytest.mark.gpu


def _pairs(rng, S_q, S_t, n):
    out = []
    for _ in range(n):
        ql = int(rng.integers(1, S_q + 1))
        tl = int(rng.integers(1, S_t + 1))
        q = rng.integers(0, 5, ql).astype(np.int8)
        t = np.resize(q, tl).copy()
        m = rng.random(tl) < 0.15
        t[m] = rng.integers(0, 5, int(m.sum()))
        out.append((q, t))
    return out


@pytest.mark.parametrize("S_q,S_t", [(128, 128), (512, 256), (256, 1024)])
def test_cuda_matches_plain_route(gpu, S_q, S_t):
    """Packed op streams of the CUDA kernel equal the plain route's byte
    for byte, lengths from 1 to the class bound, wildcards included."""
    pairs = _pairs(np.random.default_rng(S_q + S_t), S_q, S_t, 40)
    args = pack_class_batch(pairs, range(len(pairs)), S_q, S_t, 64)
    cuda = np.asarray(gap_dp_packed(*args, S_q, S_t, cuda=True))
    plain = np.asarray(wavefront_cigar_scan(*args, S_q, S_t))
    assert np.array_equal(cuda, plain)
    for i, (q, t) in enumerate(pairs[:6]):
        p, _ = wavefront_np(q, t)
        assert cigar_from_packed_ops(cuda[i], len(q), len(t)) == \
            backtrack_np(p, len(q), len(t))


def test_cuda_scratch_slots_reused(gpu, monkeypatch):
    """More problems than scratch slots: each block walks several
    problems through one slot, with identical results."""
    from sedef_tpu.native import cuda

    pairs = _pairs(np.random.default_rng(5), 256, 256, 48)
    args = pack_class_batch(pairs, range(len(pairs)), 256, 256, 48)
    want = np.asarray(gap_dp_packed(*args, 256, 256, cuda=True))
    monkeypatch.setattr(cuda, "SCRATCH_BUDGET",
                        3 * cuda.slot_bytes(256, 256))
    got = np.asarray(gap_dp_packed(*args, 256, 256, cuda=True))
    assert np.array_equal(got, want)


def test_cuda_under_jit(gpu):
    import jax

    pairs = _pairs(np.random.default_rng(9), 128, 128, 8)
    args = pack_class_batch(pairs, range(8), 128, 128, 8)
    eager = np.asarray(gap_dp_packed(*args, 128, 128, cuda=True))
    jitted = np.asarray(jax.jit(
        lambda *a: gap_dp_packed(*a, 128, 128, cuda=True))(*args))
    assert np.array_equal(eager, jitted)


def test_aligner_device_route_on_card(gpu):
    """The default aligner takes the CUDA route and matches the host."""
    pairs = _pairs(np.random.default_rng(13), 1024, 1024, 20)
    al = WavefrontAligner()
    assert al.use_device
    res = [None] * len(pairs)
    al._align_device(pairs, list(range(len(pairs))), res)
    assert res == WavefrontAligner(use_device=False).align_batch(pairs)
    assert al.device_problems == len(pairs)
