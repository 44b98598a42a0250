"""Winnowed-minimizer extraction, bug-compatible with the reference.

The reference (``src/hash.cc:53-100``) intends the classic monotonic-deque
sliding-window minimum, but its stale-entry eviction tests ``window.back()``
while popping the *front* (hash.cc:87-89).  Since an element is pushed at
every position, the back is always recent, so the front — the current
minimizer — is (almost) never evicted for being out of the window: it
persists until a new key <= every retained key arrives, or until the whole
deque goes stale at once.  This makes SEDEF's minimizers much sparser than
true winnowing and shapes every downstream stage, so we reproduce it exactly.

Equivalent state machine (derived, verified against the reference binary via
tests/fixtures/minimizers_*.txt):

    the front changes at k-mer position p  <=>
        key[p] <= min( key[j] for j in [max(q, p-w), p) )
    where q is the previous change position (empty range => change).

* k-mer key = status << 2k | hash with status in {0: HAS_UPPERCASE,
  1: ALL_LOWERCASE, 2: HAS_N} — (status, hash) lexicographic order
  (hash.cc:29-31), so N-mers sort last and uppercase first.
* emission starts at p == w (hash.cc:93-94); consecutive duplicates collapse
  (hash.cc:95-97), so the emitted minimizers are: the front active at p = w,
  then every later change point.

The scan admits a closed form (proved by induction, verified against the
scan in tests/test_winnow.py): *every* change point satisfies
``key[p] <= min(key[max(0, p-w) .. p-1])`` and vice versa — the q/m carry
state of the literal derivation is redundant.  Sketch: a change with the
previous change q inside the window needs ``kp <= min(key[q..p-1])``; by
induction q itself satisfied ``kq <= min(key[q-w..q-1])
<= min(key[p-w..q-1])``, and ``kp <= m <= kq``, so ``kp`` is also <= the
full-window minimum.  The converse (full-window min => change) is
immediate since ``m`` ranges over a subset of the window.

That makes reference-exact winnowing embarrassingly parallel:
``minimizer positions = { p : key[p] <= W[p] }`` with W a plain sliding-
window minimum — computed here as a batched JAX op (log2(w) shift-min
steps) so index construction is device-resident (the north-star "seeding
becomes batched JAX ops over packed 2-bit genome windows").
"""

from __future__ import annotations

import functools

import numpy as np

from .dna import CLS_N, CLS_UPPER

STATUS_HAS_UPPERCASE = 0
STATUS_ALL_LOWERCASE = 1
STATUS_HAS_N = 2


def kmer_keys_np(code: np.ndarray, cls: np.ndarray, k: int) -> np.ndarray:
    """Packed (status, hash) key for every k-mer position (vectorized).

    Returns int64 array of length ``len(code) - k + 1``.
    """
    n = code.shape[0] - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    h = np.zeros(n, dtype=np.int64)
    for j in range(k):
        h = (h << 2) | code[j:j + n].astype(np.int64)
    is_n = (cls == CLS_N).astype(np.int32)
    is_u = (cls == CLS_UPPER).astype(np.int32)
    pn = np.concatenate([[0], np.cumsum(is_n)])
    pu = np.concatenate([[0], np.cumsum(is_u)])
    has_n = (pn[k:] - pn[:-k]) > 0
    has_u = (pu[k:] - pu[:-k]) > 0
    status = np.where(has_n, STATUS_HAS_N,
                      np.where(has_u, STATUS_HAS_UPPERCASE,
                               STATUS_ALL_LOWERCASE)).astype(np.int64)
    return (status << (2 * k)) | h


def sliding_window_min_np(keys: np.ndarray, w: int) -> np.ndarray:
    """W[p] = min(keys[p-w .. p-1]) for p in [0, n); W[0..] over clipped
    ranges, W[0] = +inf (empty)."""
    n = keys.shape[0]
    out = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
    if n <= 1:
        return out
    # pad left with +inf so every window has width w
    pad = np.full(w - 1, np.iinfo(np.int64).max, dtype=np.int64)
    ext = np.concatenate([pad, keys[:-1]])
    sw = np.lib.stride_tricks.sliding_window_view(ext, w)  # (n-1, w)
    out[1:] = sw.min(axis=1)
    return out


def change_points_np(keys: np.ndarray, w: int) -> np.ndarray:
    """Positions where the reference deque's front changes (see module doc)."""
    n = keys.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64)
    W = sliding_window_min_np(keys, w)
    out = [0]
    q = 0
    m = int(keys[0])
    for p in range(1, n):
        kp = int(keys[p])
        bound = m if q > p - w else int(W[p])
        if kp <= bound:
            out.append(p)
            q = p
            m = kp
        elif kp < m:
            m = kp
    return np.asarray(out, dtype=np.int64)


def change_points_closed_np(keys: np.ndarray, w: int) -> np.ndarray:
    """Closed form of the change-point scan (see module doc): positions
    where key[p] <= min(key[max(0, p-w) .. p-1]).  Fully parallel."""
    if keys.shape[0] == 0:
        return np.empty(0, dtype=np.int64)
    W = sliding_window_min_np(keys, w)
    return np.nonzero(keys <= W)[0].astype(np.int64)


def minimizers_np(code: np.ndarray, cls: np.ndarray, k: int, w: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """All minimizers of a sequence: (keys int64, locs int32), loc-sorted.

    Bug-compatible equivalent of ``get_minimizers`` (hash.cc:53-100).
    """
    keys = kmer_keys_np(code, cls, k)
    n = keys.shape[0]
    if n <= w:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int32)
    cps = change_points_np(keys, w)
    # emitted = front active at p == w, then every later change point
    first = int(np.searchsorted(cps, w, side="right")) - 1
    locs = cps[first:].astype(np.int32)
    return keys[locs], locs


try:  # fast native path (exact same semantics), optional
    from ..native import lib as _native
except Exception:  # pragma: no cover
    _native = None


def minimizers(code: np.ndarray, cls: np.ndarray, k: int, w: int,
               use_device: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Dispatch: native C++ scan > device op > numpy.  The device op
    serves hosts without the native library; whether it beats the native
    scan on a GPU is not measured (ROADMAP S5)."""
    if _native is not None and _native.has("winnow"):
        return _native.winnow(code, cls, k, w)
    if use_device:
        from .winnow_device import minimizers_device
        r = minimizers_device(code, cls, k, w)
        if r is not None:
            return r
    return minimizers_np(code, cls, k, w)
