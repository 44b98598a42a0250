"""Anti-diagonal wavefront affine-gap global aligner.

Replacement for the reference's ksw2 ``extz2_sse`` kernel
(``extern/ksw2_extz2_sse.cc``, called from ``src/align.cc:39-68``).  The
reference already uses the rotated (r = i + j) difference-recurrence
formulation with 16-lane int8 SSE; here the same recurrence runs batched
on the device (``gap_dp_packed``: a CUDA kernel on a GPU, plain JAX
elsewhere) with the traceback on the device too, so only a 2-bit op per
anti-diagonal reaches the host.

Recurrence (difference encoding; one row per anti-diagonal r; lane t =
target index i; query index j = r - t):

    z   = s(t, r-t) + 2*(q+e)
    a   = x[r-1][t-1] + v[r-1][t-1]
    b   = y[r-1][t]   + u[r-1][t]
    d   = a > z ? 1 : 0 ;  z = max(z, a)
    d   = b > z ? 2 : d ;  z = max(z, b) ; z = min(z, match + 2*(q+e))
    u[r][t] = z - v[r-1][t-1] ;  v[r][t] = z - u[r-1][t]
    z' = z - q ; a' = a - z' ; b' = b - z'
    x[r][t] = max(a', 0) ; d |= (a' > 0) << 3
    y[r][t] = max(b', 0) ; d |= (b' > 0) << 4

Boundary injections per row r: the shifted lane -1 sees (x1, v1) =
(0, r ? q : 0); lane t == r of the previous state sees (u, y) =
(r ? q : 0, 0).  With a full band these are the only boundary conditions;
out-of-triangle lanes compute garbage that valid cells never read (padding
is the wildcard code 4, scoring 0 against everything, exactly like ksw2's
m-1 wildcard row/column).

CIGAR conventions match the reference mapping ("MDI"[op], align.cc:58-64):
'M' consumes both, 'D' consumes only the query (seq A), 'I' consumes only
the target (seq B).  Gap placement follows ksw2's left-alignment tie-break.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT, Config
from ..device import accelerator
from .dna import WILDCARD, encode_align

NEG_INF = -(1 << 30)


# ---------------------------------------------------------------------------
# NumPy reference implementation (exact, per-diagonal vectorized)
# ---------------------------------------------------------------------------

def wavefront_np(query: np.ndarray, target: np.ndarray, match: int = 5,
                 mis: int = -4, gapo: int = 40, gape: int = 1
                 ) -> tuple[np.ndarray, int]:
    """Full-band global DP; returns (direction matrix p, score).

    ``query``/``target`` are alignment-alphabet codes (0..3, 4 = wildcard).
    p has shape (qlen + tlen - 1, tlen): one row per anti-diagonal, lane =
    target index.  Scores use int32 (identical values to the int8 SSE kernel
    under its range invariants).
    """
    qlen, tlen = len(query), len(target)
    assert qlen > 0 and tlen > 0
    q, e = gapo, gape
    qe = q + e
    qe2 = 2 * qe
    max_sc = match + qe2
    n_diag = qlen + tlen - 1

    u = np.zeros(tlen, dtype=np.int32)
    v = np.zeros(tlen, dtype=np.int32)
    x = np.zeros(tlen, dtype=np.int32)
    y = np.zeros(tlen, dtype=np.int32)
    H = np.full(tlen, NEG_INF, dtype=np.int64)
    p = np.zeros((n_diag, tlen), dtype=np.uint8)
    score = NEG_INF

    t_idx = np.arange(tlen)
    tq = target.astype(np.int32)

    for r in range(n_diag):
        st0 = max(0, r - qlen + 1)
        en0 = min(r, tlen - 1)
        # query codes per lane: qrow[t] = query[r - t] (wildcard outside)
        j = r - t_idx
        valid_j = (j >= 0) & (j < qlen)
        qrow = np.where(valid_j, query[np.clip(j, 0, qlen - 1)], WILDCARD
                        ).astype(np.int32)
        wild = (qrow >= 4) | (tq >= 4)
        sc = np.where(wild, 0, np.where(qrow == tq, match, mis))

        # boundary injection at lane t == r (previous state)
        if r < tlen:
            u[r] = q if r > 0 else 0
            y[r] = 0
        x1 = 0
        v1 = q if r > 0 else 0
        xs = np.concatenate(([x1], x[:-1]))
        vs = np.concatenate(([v1], v[:-1]))

        z = sc + qe2
        a = xs + vs
        b = y + u
        d = (a > z).astype(np.uint8)
        z = np.maximum(z, a)
        d = np.where(b > z, np.uint8(2), d)
        z = np.maximum(z, b)
        z = np.minimum(z, max_sc)
        u_new = z - vs
        v_new = z - u
        z2 = z - q
        a2 = a - z2
        b2 = b - z2
        x = np.maximum(a2, 0)
        y = np.maximum(b2, 0)
        d |= (a2 > 0).astype(np.uint8) << 3
        d |= (b2 > 0).astype(np.uint8) << 4
        u, v = u_new, v_new
        p[r] = d

        # exact H tracking (ksw2_extz2_sse.cc:222-267) for the final score
        if r == 0:
            H[0] = v[0] - qe - qe
        else:
            if en0 > 0:
                H[en0] = H[en0 - 1] + u[en0] - qe
            else:
                H[en0] = H[en0] + v[en0] - qe
            if st0 < en0:
                H[st0:en0] += v[st0:en0] - qe
        if r == n_diag - 1 and en0 == tlen - 1:
            score = int(H[tlen - 1])
    return p, score


def backtrack_np(p: np.ndarray, qlen: int, tlen: int) -> list[tuple[str, int]]:
    """Host CIGAR backtrack from (tlen-1, qlen-1), ksw2 semantics
    (``extern/ksw2.h:117-151``) with full band (off[r] = st0, off_end[r] =
    en0 computed analytically)."""
    cigar: list[tuple[str, int]] = []

    def push(op: str, ln: int):
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + ln)
        else:
            cigar.append((op, ln))

    i, j = tlen - 1, qlen - 1
    state = 0
    while i >= 0 and j >= 0:
        r = i + j
        st0 = max(0, r - qlen + 1)
        en0 = min(r, tlen - 1)
        force_state = -1
        if i < st0:
            force_state = 2
        if i > en0:
            force_state = 1
        tmp = int(p[r, i]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2)) & 1:
            state = 0
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            push("M", 1)
            i -= 1
            j -= 1
        elif state == 1 or state == 3:
            push("I", 1)  # consumes target (reference op idx 2 -> 'I')
            i -= 1
        else:
            push("D", 1)  # consumes query  (reference op idx 1 -> 'D')
            j -= 1
    if i >= 0:
        push("I", i + 1)
    if j >= 0:
        push("D", j + 1)
    cigar.reverse()
    return cigar


def cigar_from_packed_ops(packed_row: np.ndarray, qlen: int, tlen: int
                          ) -> list[tuple[str, int]]:
    """Decode one problem's 2-bit op stream into a CIGAR."""
    b = packed_row
    ops = np.empty(4 * len(b), np.uint8)
    ops[0::4] = b & 3
    ops[1::4] = (b >> 2) & 3
    ops[2::4] = (b >> 4) & 3
    ops[3::4] = (b >> 6) & 3
    return cigar_from_ops(ops, qlen, tlen, skip=3)


def cigar_from_ops(ops_row: np.ndarray, qlen: int, tlen: int,
                   skip: int = 255) -> list[tuple[str, int]]:
    """Decode one walker's op bytes (per anti-diagonal, ``skip`` = row not
    consumed) into a CIGAR, mirroring ``backtrack_np``'s residual
    handling."""
    n_diag = qlen + tlen - 1
    seq = ops_row[:n_diag][::-1]
    seq = seq[seq != skip]
    nM = int((seq == 0).sum())
    nI = int((seq == 1).sum())
    nD = int((seq == 2).sum())
    i_end = tlen - 1 - nM - nI
    j_end = qlen - 1 - nM - nD
    parts = seq.tolist()
    if i_end >= 0:
        parts.extend([1] * (i_end + 1))
    if j_end >= 0:
        parts.extend([2] * (j_end + 1))
    cigar: list[tuple[str, int]] = []
    for opc in parts:
        opch = "MID"[opc]
        if cigar and cigar[-1][0] == opch:
            cigar[-1] = (opch, cigar[-1][1] + 1)
        else:
            cigar.append((opch, 1))
    cigar.reverse()
    return cigar


# ---------------------------------------------------------------------------
# Plain-JAX fill (compiles on any backend)
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("S_q", "S_t", "match", "mis", "gapo", "gape"))
def wavefront_scan_batch(qcodes, tgt, S_q: int, S_t: int, match: int = 5,
                         mis: int = -4, gapo: int = 40, gape: int = 1):
    """The module recurrence as a vmapped ``lax.scan`` over
    anti-diagonals.  qcodes: (B, >= S_q+S_t-1) int32; tgt: (B, S_t) int8.
    Returns p: (B, S_q + S_t - 1, S_t) uint8."""
    qe2 = 2 * (gapo + gape)
    max_sc = match + qe2
    n_diag = S_q + S_t - 1
    lane = jnp.arange(S_t, dtype=jnp.int32)

    def one(qc, tq):
        tq = tq.astype(jnp.int32)

        def step(carry, r):
            u0, v0, x0, y0, qrow_prev = carry
            qrow = jnp.where(lane == 0, qc[r], jnp.roll(qrow_prev, 1))
            wild = (qrow >= 4) | (tq >= 4)
            sc = jnp.where(wild, 0, jnp.where(qrow == tq, match, mis))
            bq = jnp.where(r > 0, gapo, 0)
            ub = jnp.where(lane == r, bq, u0)
            yb = jnp.where(lane == r, 0, y0)
            xs = jnp.where(lane == 0, 0, jnp.roll(x0, 1))
            vs = jnp.where(lane == 0, bq, jnp.roll(v0, 1))
            z = sc + qe2
            a = xs + vs
            b = yb + ub
            d = (a > z).astype(jnp.int32)
            z = jnp.maximum(z, a)
            d = jnp.where(b > z, 2, d)
            z = jnp.maximum(z, b)
            z = jnp.minimum(z, max_sc)
            un = z - vs
            vn = z - ub
            z2 = z - gapo
            a2 = a - z2
            b2 = b - z2
            xn = jnp.maximum(a2, 0)
            yn = jnp.maximum(b2, 0)
            d = d + jnp.where(a2 > 0, 8, 0) + jnp.where(b2 > 0, 16, 0)
            return (un, vn, xn, yn, qrow), d.astype(jnp.uint8)

        init = tuple(jnp.zeros(S_t, jnp.int32) for _ in range(4)) + (
            jnp.full(S_t, WILDCARD, jnp.int32),)
        _, rows = jax.lax.scan(step, init, jnp.arange(n_diag))
        return rows

    return jax.vmap(one)(qcodes, tgt)


def _pack_ops(ops):
    """(B, n) op codes 0..3 -> (B, ceil(n / 4)) bytes, row r at byte
    r // 4, bits 2 * (r % 4) (see ``cigar_from_packed_ops``)."""
    B, n = ops.shape
    pad = -n % 4
    if pad:
        ops = jnp.concatenate([ops, jnp.full((B, pad), 3, ops.dtype)], axis=1)
    o = ops.astype(jnp.uint8)
    return (o[:, 0::4] | (o[:, 1::4] << 2) | (o[:, 2::4] << 4)
            | (o[:, 3::4] << 6))


@functools.partial(
    jax.jit, static_argnames=("S_q", "S_t", "match", "mis", "gapo", "gape"))
def wavefront_cigar_scan(qseq, tgt, ql, tl, S_q: int, S_t: int,
                         match: int = 5, mis: int = -4, gapo: int = 40,
                         gape: int = 1):
    """Plain-JAX fill + traceback: ``wavefront_scan_batch`` then a
    ``lax.scan`` walk over the anti-diagonals in decreasing order (ksw2's
    state machine, ``extern/ksw2.h:117-151``, as ``backtrack_np``).

    qseq: (B, S_q) int8 query codes (wildcard padded)
    tgt:  (B, S_t) int8 target codes (wildcard padded)
    ql, tl: (B,) int32 true lengths, each >= 1
    Returns packed ops (B, ceil((S_q + S_t - 1) / 4)) uint8: 2-bit codes,
    row r at byte r // 4, bits 2 * (r % 4): 0 = M, 1 = I, 2 = D, 3 = row
    not consumed (see ``cigar_from_packed_ops``)."""
    n_diag = S_q + S_t - 1
    B = tgt.shape[0]
    qcodes = jnp.concatenate(
        [qseq.astype(jnp.int32),
         jnp.full((B, n_diag - S_q), WILDCARD, jnp.int32)], axis=1)
    p = wavefront_scan_batch(qcodes, tgt, S_q, S_t, match, mis, gapo, gape)

    def walk(p1, qlen, tlen):
        def step(carry, r):
            i, j, state = carry
            consumed = (i >= 0) & (j >= 0) & (r == i + j)
            tmp = p1[r, jnp.clip(i, 0, S_t - 1)].astype(jnp.int32)
            keep = (state != 0) & (((tmp >> (state + 2)) & 1) > 0)
            s1 = jnp.where(keep, state, tmp & 7)
            # 0 -> M (i--, j--); 1/3 -> I (i--); 2 -> D (j--)
            op = jnp.where(s1 == 0, 0, jnp.where(s1 == 2, 2, 1))
            i = jnp.where(consumed & (op != 2), i - 1, i)
            j = jnp.where(consumed & (op != 1), j - 1, j)
            state = jnp.where(consumed, s1, state)
            return (i, j, state), jnp.where(consumed, op, 3)

        init = (tlen - 1, qlen - 1, jnp.int32(0))
        _, ops = jax.lax.scan(step, init, jnp.arange(n_diag - 1, -1, -1))
        return ops[::-1]

    return _pack_ops(jax.vmap(walk)(p, ql.astype(jnp.int32),
                                    tl.astype(jnp.int32)))


def gap_dp_packed(qseq, tgt, ql, tl, S_q: int, S_t: int, match: int = 5,
                  mis: int = -4, gapo: int = 40, gape: int = 1, *,
                  cuda: bool):
    """The device route for one size-class batch: the CUDA kernel
    (``native/gap_dp.cu``) when ``cuda`` (a GPU), the plain-JAX version
    otherwise.  Both return the packed op stream of
    ``wavefront_cigar_scan``."""
    if cuda:
        from ..native.cuda import gap_dp_cuda
        return gap_dp_cuda(qseq, tgt, ql, tl, match, mis, gapo, gape)
    return wavefront_cigar_scan(qseq, tgt, ql, tl, S_q, S_t, match, mis,
                                gapo, gape)


# ---------------------------------------------------------------------------
# High-level batched API
# ---------------------------------------------------------------------------

SIZE_CLASSES = (128, 256, 512, 1024, 2048)
# largest size class the device route takes; a 60 Kbp chunk goes to the
# native scalar DP
DEVICE_MAX_CLASS = 8192
# bytes of direction matrix the plain route materializes per call
PLAIN_BUDGET = 1 << 31


def _pad_to_class(n: int) -> int:
    for s in SIZE_CLASSES:
        if n <= s:
            return s
    return ((n + 2047) // 2048) * 2048


def class_parts(idxs: list[int], S_q: int, S_t: int, cuda: bool,
                n_shards: int = 1) -> list[list[int]]:
    """Split one size class into device calls.  The CUDA kernel bounds
    its own scratch (``native/cuda.py``); the plain route materializes
    the whole direction matrix, so its calls are capped at
    ``PLAIN_BUDGET`` bytes per shard."""
    if cuda:
        return [idxs]
    cap = max(1, PLAIN_BUDGET // ((S_q + S_t - 1) * S_t))
    cap = (1 << (cap.bit_length() - 1)) * n_shards
    return [idxs[off:off + cap] for off in range(0, len(idxs), cap)]


def pack_class_batch(pairs, idxs, S_q: int, S_t: int, B: int):
    """Wildcard-padded (B, S_q) / (B, S_t) int8 code planes and (B,)
    int32 true lengths for the problems ``idxs`` of ``pairs`` (row k holds
    ``idxs[k]``; ``None`` and rows past ``len(idxs)`` are 1 x 1 padding
    problems)."""
    qseq = np.full((B, S_q), WILDCARD, np.int8)
    tgts = np.full((B, S_t), WILDCARD, np.int8)
    ql = np.ones(B, np.int32)
    tl = np.ones(B, np.int32)
    for bi, idx in enumerate(idxs):
        if idx is None:
            continue
        qc, tc = pairs[idx]
        qseq[bi, :len(qc)] = qc
        tgts[bi, :len(tc)] = tc
        ql[bi] = len(qc)
        tl[bi] = len(tc)
    return qseq, tgts, ql, tl


class WavefrontAligner:
    """Batched global aligner.

    Small batches go to the native C++ scalar DP (NumPy without the native
    library); bulk batches go to the device route (``gap_dp_packed``) when
    ``use_device`` is set.  ``use_device=None`` follows
    ``device.accelerator()``: on with a GPU, off on the CPU backend.
    """

    def __init__(self, cfg: Config = DEFAULT,
                 use_device: bool | None = None):
        import threading
        self.cfg = cfg
        self.match = cfg.align.match
        self.mis = cfg.align.mismatch          # negative
        self.gapo = -cfg.align.gap_open        # positive 40
        self.gape = -cfg.align.gap_extend      # positive 1
        # the device route: the CUDA kernel on a GPU, plain JAX elsewhere
        self._cuda = accelerator() is not None
        if use_device is None:
            use_device = self._cuda
        self.use_device = use_device
        # gap DPs and DP cells the device route took
        self.device_problems = 0
        self.device_cells = 0
        self._count_lock = threading.Lock()

    def align_codes(self, query: np.ndarray, target: np.ndarray
                    ) -> list[tuple[str, int]]:
        """Global alignment of one pair of code arrays -> CIGAR list."""
        return self.align_batch([(query, target)])[0]

    # Batches at least this large, carrying at least this many DP cells,
    # go to the device route in one dispatch; devcal.apply() rescales both
    # from the measured dispatch latency (override the cell bound with
    # SEDEF_DEVICE_BATCH_MIN_CELLS).
    DEVICE_BATCH_MIN = 256
    DEVICE_BATCH_MIN_CELLS = int(os.environ.get(
        "SEDEF_DEVICE_BATCH_MIN_CELLS", 1 << 25))

    def align_batch(self, pairs: list[tuple[np.ndarray, np.ndarray]]
                    ) -> list[list[tuple[str, int]]]:
        """Align many (query, target) code pairs."""
        results: list[list[tuple[str, int]] | None] = [None] * len(pairs)
        native = None
        try:
            from ..native import lib as _nlib
            if _nlib.has("align"):
                native = _nlib
        except Exception:  # pragma: no cover
            native = None
        host_idx = []
        for idx, (qc, tc) in enumerate(pairs):
            if len(qc) == 0 or len(tc) == 0:
                results[idx] = _degenerate_cigar(len(qc), len(tc))
            else:
                host_idx.append(idx)
        device_idx: list[int] = []
        if self.use_device and (native is None
                                or len(host_idx) >= self.DEVICE_BATCH_MIN):
            fits = [i for i in host_idx
                    if max(len(pairs[i][0]), len(pairs[i][1]))
                    <= DEVICE_MAX_CLASS]
            cells = sum(len(pairs[i][0]) * len(pairs[i][1]) for i in fits)
            if native is None or cells >= self.DEVICE_BATCH_MIN_CELLS:
                device_idx = fits
                taken = set(fits)
                host_idx = [i for i in host_idx if i not in taken]
        self._align_host(pairs, host_idx, results, native)
        if device_idx:
            self._align_device(pairs, device_idx, results)
        return results

    def _align_host(self, pairs, idxs, results, native) -> None:
        """Native scalar DP (one ctypes round trip for the whole set), or
        the NumPy reference without the native library."""
        if not idxs:
            return
        if native is None:
            for idx in idxs:
                qc, tc = pairs[idx]
                p, _ = wavefront_np(qc, tc, self.match, self.mis,
                                    self.gapo, self.gape)
                results[idx] = backtrack_np(p, len(qc), len(tc))
            return
        sub = [(pairs[i][0].astype(np.uint8), pairs[i][1].astype(np.uint8))
               for i in idxs]
        if native.has("align_batch"):
            cigs = native.align_batch(sub, self.match, self.mis, self.gapo,
                                      self.gape)
        else:  # pragma: no cover - align_batch ships with the library
            cigs = [native.align(q, t, self.match, self.mis, self.gapo,
                                 self.gape) for q, t in sub]
        for i, cig in zip(idxs, cigs):
            results[i] = cig

    def device_groups(self, pairs, idxs) -> dict[tuple[int, int], list[int]]:
        """Problems of ``idxs`` grouped by padded (S_q, S_t) size class."""
        groups: dict[tuple[int, int], list[int]] = {}
        for idx in idxs:
            qc, tc = pairs[idx]
            key = (_pad_to_class(len(qc)), _pad_to_class(len(tc)))
            groups.setdefault(key, []).append(idx)
        return groups

    def count_device(self, pairs, idxs) -> None:
        cells = sum(len(pairs[i][0]) * len(pairs[i][1]) for i in idxs)
        with self._count_lock:
            self.device_problems += len(idxs)
            self.device_cells += cells

    def _align_device(self, pairs, idxs, results) -> None:
        """Device route per size class; batches are padded to a power of
        two so each (B, S_q, S_t) shape compiles once per process."""
        from ..debug import dprn
        for (S_q, S_t), cls_idx in self.device_groups(pairs, idxs).items():
            dprn("[aligner] class ({}, {}): {} problems", S_q, S_t,
                 len(cls_idx))
            for part in class_parts(cls_idx, S_q, S_t, self._cuda):
                B = 1 << max(3, (len(part) - 1).bit_length())
                ops = np.asarray(gap_dp_packed(
                    *pack_class_batch(pairs, part, S_q, S_t, B), S_q, S_t,
                    self.match, self.mis, self.gapo, self.gape,
                    cuda=self._cuda))
                for bi, idx in enumerate(part):
                    qc, tc = pairs[idx]
                    results[idx] = cigar_from_packed_ops(ops[bi], len(qc),
                                                         len(tc))
            self.count_device(pairs, cls_idx)

    def align_strings(self, a: str, b: str) -> list[tuple[str, int]]:
        """Chunked global alignment of raw strings, reproducing the
        reference's 60 Kbp diagonal chunking (``align.cc:46-66``).

        The chunks are independent (the reference simply concatenates
        their CIGARs), so they are aligned as ONE batch."""
        max_len = self.cfg.align.max_ksw_seq_len
        qc_full = encode_align(a)
        tc_full = encode_align(b)
        min_len = min(len(a), len(b))
        # NOTE: like the reference (align.cc:46-47), when min_len == 0 the
        # loop body never runs and the CIGAR is empty; tails of the longer
        # sequence past the final chunk are likewise not consumed.
        chunks = [(qc_full[sp:sp + max_len], tc_full[sp:sp + max_len])
                  for sp in range(0, min_len, max_len)]
        parts = self.align_batch(chunks) if chunks else []
        cigar: list[tuple[str, int]] = []
        for part in parts:
            for op, ln in part:
                if cigar and cigar[-1][0] == op:
                    cigar[-1] = (op, cigar[-1][1] + ln)
                else:
                    cigar.append((op, ln))
        return cigar


class CoalescingAligner:
    """Thread-safe wrapper that merges ``align_batch`` calls issued by
    concurrent workers into single device dispatches.

    The reference fans stage 2b over GNU-Parallel processes
    (``sedef.sh:187-190``); here independent regions run on threads and
    their gap-alignment batches coalesce, so the number of device round
    trips per bucket drops from O(regions x align rounds) to O(align
    rounds) — the decisive factor when per-dispatch latency is high.
    Results are identical to per-call dispatch: the kernel is
    batch-composition independent (each problem is solved in its own
    lanes) and routing (native vs device) is per-problem.
    """

    def __init__(self, base: "WavefrontAligner", window_s: float = 0.004):
        import threading
        self.base = base
        self.cfg = base.cfg
        self.window_s = window_s
        self._cv = threading.Condition()
        self._pending: list[list] = []
        self._dispatching = False

    @property
    def use_device(self) -> bool:
        return bool(getattr(self.base, "use_device", False))

    def align_batch(self, pairs):
        import time as _time
        if not pairs:
            return []
        if not self.use_device:
            # host-only base: nothing to amortize — the window sleep
            # would serialize threads behind a 4 ms pause per round for
            # zero benefit (measured: ~3x align-stage inflation on the
            # dense-region regime).  The native per-problem path is
            # thread-safe (thread_local buffers), so dispatch directly.
            return self.base.align_batch(pairs)
        req = [pairs, None]
        with self._cv:
            self._pending.append(req)
            while req[1] is None and self._dispatching:
                self._cv.wait()
            if req[1] is not None:
                return req[1]
            self._dispatching = True
        try:
            while req[1] is None:
                _time.sleep(self.window_s)
                with self._cv:
                    batch = self._pending
                    self._pending = []
                if not batch:
                    break
                union = [p for r in batch for p in r[0]]
                results = self.base.align_batch(union)
                with self._cv:
                    i = 0
                    for r in batch:
                        n = len(r[0])
                        r[1] = results[i:i + n]
                        i += n
                    self._cv.notify_all()
        finally:
            with self._cv:
                self._dispatching = False
                self._cv.notify_all()
        return req[1]

    def align_codes(self, query, target):
        return self.align_batch([(query, target)])[0]

    def align_strings(self, a: str, b: str):
        return self.base.align_strings(a, b)


def _degenerate_cigar(qlen: int, tlen: int) -> list[tuple[str, int]]:
    out = []
    if qlen:
        out.append(("D", qlen))
    if tlen:
        out.append(("I", tlen))
    return out
