"""Recompute-wide device prefilter for the stage-1 roll (SURVEY §7.1).

The reference's hottest loop (``src/search.cc:289-315``) rolls a ~700 bp
reference window 1 bp at a time over each candidate interval, maintaining
the incremental path-dependent sketch of ``src/sliding.cc``.  Replaying
that op stream on device is a loss (see ops/roll_engine.py) — so instead
of replaying it, this module *bounds* it, batched over every planned
interval at once, and proves most intervals cannot pass the Jaccard gate
without any sequential work at all.

Soundness (why a bound suffices for byte-identical output):

* The sliding map's ``add`` (sliding.cc:69-93) counts a new shared
  element only when it lands STRICTLY below the boundary iterator
  (``it->first < boundary->first``, sliding.cc:86); an element landing
  exactly ON the boundary — inside the sketch window — is silently not
  counted.  Every other update (``remove``'s ``<=`` test, the boundary
  steps on insert/erase, the query-side adds) applies the exact delta of
  the *ideal* sketch intersection — the number of shared keys among the
  |Q| smallest elements of the union W(A) ∪ W(B), boundary inclusive.
  The counter's deviation from ideal is therefore a sum of missed
  increments only:

      intersection(step) <= ideal(window composition at that step)

  for every step of every op stream.
* Every window the roll evaluates is a loci-window of length
  ``init_len``; its composition (the set of reference minimizers inside)
  changes only when the window boundary crosses a minimizer locus, so
  the distinct compositions of an interval's roll are exactly the
  windows starting at ``t0`` or at ``locs[i]+1`` / ``locs[i]-L+1``
  (clamped to ``[t0, t0+n_steps]``) for span minimizers ``i`` —
  ~``2*span+1`` candidate offsets.  If

      max over those compositions of ideal < limit

  (the sketch's relaxed Jaccard cutoff — fixed during the roll because
  the query side never changes), the roll provably ends with
  ``jaccard() < 0``: the interval takes the JACCARD_FAILED branch with
  no hit and no tree update, so skipping it is byte-identical (native
  sedef_search's ``dev[0] < 0`` path still bumps the total/jaccard
  funnel counters).

The device formulation is recompute-wide over increment-narrow: each
composition is one independent row — gather its <=RW window keys, sort,
dedup, and merge-rank against the window's sorted query sketch (the
``ideal`` count, computed exactly like :func:`sketch_intersection` in
ops/jaccard_batch.py) — thousands of rows per dispatch with no
sequential dependence, versus the scalar engine's O(steps) chain of
O(log W) ordered-map ops.  The host rolls only the surviving intervals.
A violation of the bound is impossible by the argument above;
tests/test_prefilter.py re-verifies it empirically against the scalar
SlidingJaccard oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INF32 = np.int32(2**31 - 1)

DEFAULT_SQ = 160   # max distinct query-window keys
DEFAULT_RW = 192   # max minimizers inside one init_len window
DEFAULT_SA = 1024  # max minimizers inside one interval SPAN (phase A)
ROW_BATCHES = (8192, 131072)  # composition rows per dispatch (2 compiles)


@functools.partial(jax.jit, static_argnames=("SQ",))
def _window_sketches(q_keys, qws, qwe, limit_lut, SQ: int):
    """Per-interval sorted distinct query-window keys + relaxed limit.

    Returns (qk (B, SQ) int32 INF-padded ascending, s (B,), limit (B,),
    ovf (B,) bool)."""
    B = qws.shape[0]
    nq = q_keys.shape[0]
    gq = qws[:, None] + jax.lax.broadcasted_iota(jnp.int32, (1, SQ), 1)
    valq = gq < qwe[:, None]
    qk = jnp.where(valq, jnp.take(q_keys, jnp.minimum(gq, nq - 1)), INF32)
    qk = jnp.sort(qk, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros((B, 1), bool), qk[:, 1:] == qk[:, :-1]], axis=1)
    qk = jnp.sort(jnp.where(dup, INF32, qk), axis=1)
    s = jnp.sum(qk != INF32, axis=1).astype(jnp.int32)
    limit = limit_lut[jnp.minimum(s, limit_lut.shape[0] - 1)]
    return qk, s, limit, (qwe - qws) > SQ


@functools.partial(jax.jit, static_argnames=("SA", "n_shift"))
def _span_intersections(r_keys, qk_all, sa, sb, SA: int, n_shift: int):
    """Phase A: plain distinct-intersection bound per interval.

    For any window W inside an interval's span, ideal(Q, R_W) <=
    |Q ∩ R_W| <= |Q ∩ R_span| — so one row per INTERVAL (vs one per
    window composition) proves most fail-heavy intervals dead before any
    composition row is built.  sa/sb (B,) int32: the span's [sa, sb)
    minimizer range (host-computed).  Rows align 1:1 with qk_all (no
    interval gather).  Returns (B,) int32 |Q ∩ R_span|, INF32 where the
    span overflowed SA (no bound)."""
    nrr = r_keys.shape[0]
    ovf = (sb - sa) > SA
    gi = sa[:, None] + jax.lax.broadcasted_iota(jnp.int32, (1, SA), 1)
    val = gi < sb[:, None]
    keys_w = jnp.where(val, jnp.take(r_keys, jnp.minimum(gi, nrr - 1)),
                       INF32)
    keys_w = jnp.where((keys_w >> n_shift) == 2, INF32, keys_w)
    keys_w = jnp.sort(keys_w, axis=1)
    from .jaccard_batch import merge_rank_intersection
    # rank condition disabled (s = row width): plain intersection count
    full = jnp.full(sa.shape, np.int32(qk_all.shape[1] + SA))
    inter = merge_rank_intersection(qk_all, keys_w, full)
    return jnp.where(ovf, INF32, inter)


@functools.partial(jax.jit, static_argnames=("RW", "n_shift"))
def _composition_ideals(r_keys, qk_all, s_all, a, b, iv_id,
                        RW: int, n_shift: int):
    """Ideal sketch intersection for one batch of composition rows.

    a/b (N,) int32: each window's [a, b) minimizer range in locus order
    (computed on the host, keeping a per-element binary-search gather
    chain off the device); iv_id (N,) int32 interval index into
    qk_all/s_all.  Returns (N,) int32 ideal counts, or INF32 where the window overflowed RW (no
    bound for that row)."""
    nrr = r_keys.shape[0]
    ovf = (b - a) > RW

    gi = a[:, None] + jax.lax.broadcasted_iota(jnp.int32, (1, RW), 1)
    val = gi < b[:, None]
    keys_w = jnp.where(val, jnp.take(r_keys, jnp.minimum(gi, nrr - 1)),
                       INF32)
    # HAS_N ref keys are never added to the sketch (sliding.cc:158-168)
    keys_w = jnp.where((keys_w >> n_shift) == 2, INF32, keys_w)
    keys_w = jnp.sort(keys_w, axis=1)

    qk = jnp.take(qk_all, iv_id, axis=0)          # (N, SQ)
    s = jnp.take(s_all, iv_id)

    # ideal = |{k in Q ∩ R : rank_union(k) < s}| — the canonical batched
    # union-rank reduction; duplicate window keys collapse inside it, so
    # no separate dedup pass is needed
    from .jaccard_batch import merge_rank_intersection
    ideal = merge_rank_intersection(qk, keys_w, s)
    return jnp.where(ovf, INF32, ideal)


def _ragged_arange(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """concatenate([arange(s, s+c) for s, c in zip(starts, counts)])."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    off = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return (np.arange(total, dtype=np.int64)
            - np.repeat(off, counts) + np.repeat(starts, counts))


class PendingPrefilter:
    """In-flight prefilter verdicts: the device dispatches are launched
    (async) and ``collect()`` blocks on the results.  Keeping dispatch and
    collect separate lets the pipeline overlap the device round trips of
    one chromosome pair with the host planning/searching of the
    next (models/pipeline.py search_job two-phase loop)."""

    def __init__(self, pf, n, bj, bs, ok, ctx):
        self._pf = pf
        self._n = n
        self._bj, self._bs, self._ok = bj, bs, ok
        self._ctx = ctx

    def collect(self):
        """Block on the device results; returns (best_j, best_steps, ok).

        Phase A (one span-bound row per interval, dispatched async) is
        pulled first; composition rows (phase B) are built and dispatched
        ONLY for the phase-A survivors — rows are the device cost driver,
        and on fail-heavy workloads phase A kills most of them for ~1% of
        the cost."""
        n = self._n
        if n == 0 or self._ctx is None:
            return self._bj, self._bs, self._ok
        ctx = self._ctx
        self._ctx = None
        span_i = np.asarray(ctx["span_i"])[:n].astype(np.int64)
        limit = np.asarray(ctx["limit"])[:n].astype(np.int64)
        s_all = np.asarray(ctx["s_all"])[:n]
        qovf = np.asarray(ctx["qovf"])[:n]
        eligible = (~qovf) & (s_all > 0)
        verdict = eligible & (span_i < limit)

        survivors = np.nonzero(eligible & ~verdict)[0].astype(np.int64)
        if len(survivors):
            pending, row_iv = self._pf._dispatch_compositions(
                ctx, survivors)
            ideal_max = np.zeros(n, np.int64)
            for part, m, out in pending:
                np.maximum.at(ideal_max, row_iv[part],
                              np.asarray(out)[:m].astype(np.int64))
            verdict[survivors] |= ideal_max[survivors] < limit[survivors]
        self._bj[verdict] = -1
        self._ok[:] = verdict
        return self._bj, self._bs, self._ok


class RollPrefilter:
    """Batches planned intervals into composition rows and returns
    per-interval verdicts in the native ``sedef_search`` results contract:
    (best_j=-1, best_steps=0, ok=True) where the roll provably fails the
    Jaccard gate; ok=False (host rolls) everywhere else."""

    def __init__(self, kmer_size: int, limit_lut: np.ndarray,
                 init_len: int, SQ: int = DEFAULT_SQ, RW: int = DEFAULT_RW,
                 SA: int = DEFAULT_SA):
        if kmer_size > 14:
            raise ValueError("packed int32 keys need 2k+2 <= 30 (k <= 14)")
        self.n_shift = 2 * kmer_size
        self.limit_lut = jnp.asarray(limit_lut.astype(np.int32))
        self.L = int(init_len)
        self.SQ = SQ
        self.RW = RW
        self.SA = SA

    def run(self, q_keys_dev, r_keys_dev,
            r_locs_host: np.ndarray, qws, qwe, t0, rws0, n_steps):
        """Verdicts for all planned intervals (plan order) — dispatch +
        blocking collect."""
        return self.dispatch(q_keys_dev, r_keys_dev,
                             r_locs_host, qws, qwe, t0, rws0,
                             n_steps).collect()

    def dispatch(self, q_keys_dev, r_keys_dev,
                 r_locs_host: np.ndarray, qws, qwe, t0, rws0, n_steps
                 ) -> PendingPrefilter:
        """Launch the device dispatches for all planned intervals (plan
        order) without blocking; the returned handle's ``collect()``
        yields the verdicts.

        r_locs_host: unpadded host loci (event construction);
        qws/qwe: per-interval query window minimizer range;
        t0/rws0/n_steps: plan interval columns."""
        n = len(qws)
        bj = np.zeros(n, np.int32)
        bs = np.zeros(n, np.int32)
        ok = np.zeros(n, bool)
        if n == 0:
            return PendingPrefilter(self, 0, bj, bs, ok, None)
        qws = np.asarray(qws, np.int32)
        qwe = np.asarray(qwe, np.int32)
        t0 = np.asarray(t0, np.int64)
        rws0 = np.asarray(rws0, np.int64)
        n_steps = np.asarray(n_steps, np.int64)

        # ---- per-interval query sketches (one dispatch) ----
        # pow2-pad the interval axis: each distinct shape is a fresh XLA
        # compile
        n_pad = max(1 << max(n - 1, 1).bit_length(), 1 << 10)
        qws_p = np.zeros(n_pad, np.int32)
        qwe_p = np.zeros(n_pad, np.int32)
        qws_p[:n] = qws
        qwe_p[:n] = qwe
        qk_all, s_all, limit, qovf = _window_sketches(
            q_keys_dev, jnp.asarray(qws_p), jnp.asarray(qwe_p),
            self.limit_lut, SQ=self.SQ)

        # ---- phase A: one span-bound row per interval (async) ----
        # span [sa, sb) covers every window the roll can visit; rws0 IS
        # native find_minimizers(t0) — the identical left-searchsorted —
        # so reuse it as the span start rather than recomputing
        sa = rws0.astype(np.int32)
        span_end = np.searchsorted(r_locs_host, t0 + n_steps + self.L,
                                   side="left").astype(np.int64)
        sa_p = np.zeros(n_pad, np.int32)
        sb_p = np.zeros(n_pad, np.int32)
        sa_p[:n] = sa
        sb_p[:n] = span_end.astype(np.int32)
        span_i = _span_intersections(
            r_keys_dev, qk_all, jnp.asarray(sa_p), jnp.asarray(sb_p),
            SA=self.SA, n_shift=self.n_shift)

        ctx = dict(span_i=span_i, limit=limit, s_all=s_all, qovf=qovf,
                   qk_all=qk_all, r_keys_dev=r_keys_dev,
                   r_locs_host=r_locs_host, t0=t0, rws0=rws0,
                   n_steps=n_steps, span_end=span_end)
        return PendingPrefilter(self, n, bj, bs, ok, ctx)

    def _dispatch_compositions(self, ctx, survivors: np.ndarray):
        """Phase B: composition rows for the phase-A survivor intervals.

        Every distinct window the roll visits starts at t0 or at a
        (clamped) minimizer-boundary event; each becomes one row of the
        batched ideal evaluation.  Returns (pending, row_iv) for the
        collector."""
        r_locs_host = ctx["r_locs_host"]
        t0, rws0 = ctx["t0"], ctx["rws0"]
        n_steps, span_end = ctx["n_steps"], ctx["span_end"]

        span_n = np.maximum(span_end - rws0, 0)[survivors]
        idx = _ragged_arange(rws0[survivors], span_n)
        ev_loc = r_locs_host[idx].astype(np.int64)
        row_iv1 = np.repeat(survivors.astype(np.int32), span_n)
        lo = t0[row_iv1]
        hi = t0[row_iv1] + n_steps[row_iv1]
        rs_events = np.concatenate([
            np.clip(ev_loc + 1, lo, hi),           # remove-boundary events
            np.clip(ev_loc - self.L + 1, lo, hi),  # add-boundary events
            t0[survivors],                         # the initial window
        ])
        row_iv = np.concatenate([row_iv1, row_iv1,
                                 survivors.astype(np.int32)])
        rs_events = rs_events.astype(np.int64)

        # window [a, b) minimizer bounds on HOST (np.searchsorted over the
        # unpadded loci) — an on-device searchsorted is a per-element
        # binary-search gather chain and was the dominant batch cost
        wa = np.searchsorted(r_locs_host, rs_events,
                             side="left").astype(np.int32)
        wb = np.searchsorted(r_locs_host, rs_events + self.L,
                             side="left").astype(np.int32)

        # ---- batched ideal evaluation (async dispatches) ----
        N = len(rs_events)
        pending = []
        offv = 0
        while offv < N:
            B = ROW_BATCHES[-1]
            for rb in ROW_BATCHES:
                if N - offv <= rb:
                    B = rb
                    break
            part = slice(offv, min(offv + B, N))
            m = part.stop - part.start
            pad = B - m
            a_b = wa[part]
            b_b = wb[part]
            iv_b = row_iv[part]
            if pad:
                a_b = np.concatenate([a_b, np.zeros(pad, np.int32)])
                b_b = np.concatenate([b_b, np.zeros(pad, np.int32)])
                iv_b = np.concatenate([iv_b, np.zeros(pad, np.int32)])
            out = _composition_ideals(
                ctx["r_keys_dev"], ctx["qk_all"], ctx["s_all"],
                a_b, b_b, iv_b, RW=self.RW, n_shift=self.n_shift)
            pending.append((part, m, out))
            offv = part.stop
        return pending, row_iv
