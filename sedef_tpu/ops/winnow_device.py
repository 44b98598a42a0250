"""Device-resident winnowed-minimizer extraction and index build.

Device formulation of ``get_minimizers`` + ``Index`` construction
(``src/hash.cc:53-141``), built on the closed form proved in
``ops/winnow.py``:

    minimizer positions  =  { p : key[p] <= min(key[max(0,p-w) .. p-1]) }

Everything is a fixed-shape batched array op:

* rolling 2-bit k-mer pack  — k unrolled shift-or adds (int32; the packed
  (status, hash) key needs 2k+2 bits, so the device path requires k <= 14;
  the reference default is k = 12),
* HAS_N / HAS_UPPERCASE window status — two prefix sums,
* sliding-window minimum — log2(w) shift-min doubling steps
  (sparse-table combine, exact for any w),
* minimizer compaction — masked cumsum (``jnp.nonzero`` with static size),
* posting-list order — one device sort (stable, ties resolved by locus
  order exactly like the host ``np.argsort(kind="stable")``).

Shapes are padded to a small geometric ladder of sizes so the jit cache
stays tiny across a whole genome's chromosomes.  The minimizer capacity is
1/6 of the padded k-mer count (the quirky winnow emits ~5.6 % of positions
on DNA); on overflow the caller falls back to the host path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .winnow import (STATUS_ALL_LOWERCASE, STATUS_HAS_N,
                     STATUS_HAS_UPPERCASE)

INF32 = np.int32(2**31 - 1)

# minimum padded size; below this the host scan is faster than a dispatch
_MIN_PAD = 1 << 14


def _pad_size(n: int) -> int:
    """Smallest 2^a or 1.5*2^a >= n — at most two jit variants per octave."""
    if n <= _MIN_PAD:
        return _MIN_PAD
    a = 1 << (int(n - 1).bit_length() - 1)  # largest pow2 < n... or == n
    if a >= n:
        return a
    if 3 * a // 2 >= n:
        return 3 * a // 2
    return 2 * a


def _sliding_min_prev(keys, w: int):
    """W[p] = min(keys[p-w .. p-1]) with +INF where the range is empty."""
    n = keys.shape[0]
    pad = jnp.full((w,), INF32, dtype=jnp.int32)
    arr = jnp.concatenate([pad, keys])  # arr[i] = keys[i - w]
    # sparse table: m[i] = min(arr[i .. i+s-1])
    m = arr
    s = 1
    while s * 2 <= w:
        m = jnp.minimum(m[:-s], m[s:])
        s *= 2
    # combine two width-s windows covering [p, p+w)
    lo = m[:n]
    hi = m[w - s:w - s + n]
    return jnp.minimum(lo, hi)


def _windowed_or(bits, k: int, nk: int):
    """out[p] = any(bits[p .. p+k-1]) via log2(k) shift-max doubling."""
    m = bits
    s = 1
    while s * 2 <= k:
        m = jnp.maximum(m[:-s], m[s:])
        s *= 2
    return jnp.maximum(m[:nk], m[k - s:k - s + nk])


@functools.partial(jax.jit, static_argnames=("k", "w", "cap"))
def _device_index(code, cls, nk_valid, k: int, w: int, cap: int,
                  drop=np.int32(0)):
    """code, cls: (pad_n,) uint8.  Returns (count, locs, keys) — int32,
    minimizer arrays nk/INF-padded past ``count``.  The posting sort is
    done host-side on the (much smaller) downloaded slice, so the op
    returns the minimum bytes.

    ``drop`` > 0 marks a continuation segment: the first ``drop`` kmer
    positions are left context for the sliding minimum only (their change
    points were emitted by the previous segment) and the sequence-start
    emission rule does not apply."""
    pad_n = code.shape[0]
    nk = pad_n - k + 1

    # rolling 2-bit pack (k static, unrolled)
    h = jnp.zeros((nk,), dtype=jnp.int32)
    for j in range(k):
        h = (h << 2) | code[j:j + nk].astype(jnp.int32)

    # window status via windowed-or (kmer_keys_np equivalent)
    is_n = (cls == 2).astype(jnp.uint8)
    is_u = (cls == 0).astype(jnp.uint8)
    has_n = _windowed_or(is_n, k, nk) > 0
    has_u = _windowed_or(is_u, k, nk) > 0
    status = jnp.where(has_n, STATUS_HAS_N,
                       jnp.where(has_u, STATUS_HAS_UPPERCASE,
                                 STATUS_ALL_LOWERCASE)).astype(jnp.int32)
    keys = (status << (2 * k)) | h

    # closed-form change points (ops/winnow.py module doc)
    W = _sliding_min_prev(keys, w)
    idx = jax.lax.broadcasted_iota(jnp.int32, (nk, 1), 0)[:, 0]
    cmask = (keys <= W) & (idx < nk_valid)

    # emission starts at the front active at p == w (hash.cc:93-97): keep
    # the LAST change point <= w plus everything after it.  Continuation
    # segments (drop > 0) instead suppress their left-context kmers.
    prefix_last = jnp.max(jnp.where(cmask & (idx <= w), idx, -1))
    emit = cmask & (idx >= jnp.where(drop > 0, drop, prefix_last))

    count = emit.sum().astype(jnp.int32)
    locs = jnp.nonzero(emit, size=cap, fill_value=nk)[0].astype(jnp.int32)
    valid = locs < nk
    mkeys = jnp.where(valid, keys[jnp.minimum(locs, nk - 1)], INF32)
    return count, locs, mkeys


@functools.partial(jax.jit, static_argnames=("m",))
def _slice2(a, b, m: int):
    return a[:m], b[:m]


# fixed device segment: winnowing is position-local (a change point
# depends only on the preceding w keys), so any chromosome is processed
# as fixed-shape segments with w + k - 1 codes of left overlap — the
# kernel compiles for exactly TWO shapes (_MIN_PAD for tiny inputs, _SEG
# for everything else) no matter the genome.
_SEG = 1 << 22


def _run_segments(code: np.ndarray, cls: np.ndarray, k: int, w: int):
    """Yields ((lo, count, dlocs, dkeys), cap) per segment.  All segments
    are dispatched before any result is consumed (async pipelining)."""
    n = code.shape[0]
    pad_n = _MIN_PAD if n <= _MIN_PAD else _SEG
    cap = (pad_n - k + 1) // 6
    nk_seg = pad_n - k + 1
    pending = []
    p0 = 0  # first kmer position this segment emits
    while p0 < n - k + 1:
        lo = max(0, p0 - w)  # w kmers of left context for the window min
        seg_code = code[lo:lo + pad_n]
        seg_cls = cls[lo:lo + pad_n]
        if seg_code.shape[0] < pad_n:
            fill = pad_n - seg_code.shape[0]
            seg_code = np.concatenate(
                [seg_code, np.zeros(fill, dtype=np.uint8)])
            seg_cls = np.concatenate(
                [seg_cls, np.full(fill, 2, dtype=np.uint8)])
        nk_valid = min(nk_seg, n - lo - k + 1)
        drop = p0 - lo  # overlap kmers to suppress (0 for the first)
        count, dlocs, dkeys = _device_index(
            seg_code, seg_cls, np.int32(nk_valid), k, w, cap,
            np.int32(drop))
        pending.append((lo, count, dlocs, dkeys))
        p0 = lo + nk_seg  # next segment emits from the first unseen kmer
    for item in pending:
        yield item, cap


def device_index_arrays(code: np.ndarray, cls: np.ndarray, k: int, w: int):
    """Full minimizer-index arrays on device.

    Returns (keys int64, locs int32, skeys int64, slocs int32) exactly
    matching the host ``minimizers_np`` + stable key sort, or ``None`` when
    the device path does not apply (k > 14, tiny input, or capacity
    overflow — callers fall back to the host scan).
    """
    if k > 14:
        return None
    n = code.shape[0]
    if n - k + 1 <= w:
        return None
    all_keys = []
    all_locs = []
    for (lo, count, dlocs, dkeys), cap in _run_segments(code, cls, k, w):
        count = int(count)
        if count > cap:  # pragma: no cover - genome-dependent
            return None
        # pow2-only slice sizes: each distinct m is a (tiny) compile
        m = min(cap, max(1 << max(count - 1, 1).bit_length(), 1 << 12))
        dlocs, dkeys = _slice2(dlocs, dkeys, m)
        locs = np.asarray(dlocs)[:count].astype(np.int64)
        keys = np.asarray(dkeys)[:count].astype(np.int64)
        all_locs.append(locs + lo)
        all_keys.append(keys)
    keys = np.concatenate(all_keys)
    locs = np.concatenate(all_locs).astype(np.int32)
    order = np.argsort(keys, kind="stable")
    return keys, locs, keys[order], locs[order]


def minimizers_device(code: np.ndarray, cls: np.ndarray, k: int, w: int):
    """(keys, locs) via the device op; None if not applicable."""
    r = device_index_arrays(code, cls, k, w)
    if r is None:
        return None
    keys, locs, _, _ = r
    return keys, locs
