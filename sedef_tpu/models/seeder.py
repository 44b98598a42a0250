"""Stage-1 seed search: sliding-Jaccard SD discovery over minimizer indexes.

Semantics-equivalent rewrite of ``src/search.cc`` + ``src/search_main.cc``:
per query window, candidate ref loci are collected from posting lists,
clustered into intervals, each interval's 700 bp window is rolled to the
best Jaccard position, filtered (uppercase + q-gram), greedily extended
minimizer-by-minimizer in three modes, and deduplicated against an
interval tree of already-reported hit rectangles.

The boost-ICL two-level interval map (search.h:31-34) is replaced by
``HitTree`` — a pruned rectangle list with identical query semantics: the
is_overlap / candidate-prune tests only ever ask "which stored rectangles
contain this (query, ref) point", and the only domain subtraction is a
monotonically-growing prefix (search.cc:469), which can never hide a
rectangle from the always-larger future query points — so pruning fully-
passed rectangles is exactly equivalent.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from ..config import DEFAULT, Config
from ..io.bed import Hit, SeqRef
from ..ops import filter as filt
from ..ops.dna import PackedSeq
from ..ops.index import MinimizerIndex
from ..ops.sliding import SlidingJaccard
from ..ops.winnow import STATUS_HAS_UPPERCASE


class HitTree:
    """Rectangle set with 2D point-containment queries (see module doc)."""

    def __init__(self):
        self.rects: list[tuple[int, int, int, int]] = []  # (qs, qe, rs, re)

    def add(self, qs: int, qe: int, rs: int, re_: int) -> None:
        self.rects.append((qs, qe, rs, re_))

    def prune(self, upto: int) -> None:
        """tree -= [0, upto): rectangles with qe <= upto become invisible to
        all future (monotonically larger) query points."""
        if upto <= 0:
            return
        self.rects = [r for r in self.rects if r[1] > upto]

    def covering(self, q: int, r: int):
        for qs, qe, rs, re_ in self.rects:
            if qs <= q < qe and rs <= r < re_:
                yield (qs, qe, rs, re_)

    def covers(self, q: int, r: int) -> bool:
        for _ in self.covering(q, r):
            return True
        return False


def is_overlap(tree: HitTree, pf_pos: int, pf_end: int, pfp_pos: int,
               pfp_end: int, cfg: Config) -> bool:
    """search.cc:35-71"""
    for sA, eA, sB, eB in tree.covering(pf_pos, pfp_pos):
        # 1. total containment
        if pf_pos >= sA and pf_end <= eA and pfp_pos >= sB and pfp_end <= eB:
            return True
        # 2. ignore small stored intervals
        if min(eA - sA, eB - sB) < cfg.search.min_read_size * 1.5:
            continue
        # 3. require a substantial right-side overlap
        right_allowance = cfg.search.min_read_size
        if eA - pf_pos >= right_allowance and eB - pfp_pos >= right_allowance:
            return True
    return False


def parse_hits(hits: list[Hit]) -> list[Hit]:
    """Drop hits fully contained in another hit of this batch
    (search.cc:73-91)."""
    out = []
    for i, h in enumerate(hits):
        add = True
        for j, ph in enumerate(hits):
            if i != j and (h.ref_start >= ph.ref_start
                           and h.ref_end <= ph.ref_end
                           and h.query_start >= ph.query_start
                           and h.query_end <= ph.query_end):
                add = False
                break
        if add:
            out.append(h)
    return out


def extend(winnow: SlidingJaccard, query_hash: MinimizerIndex,
           query_start: int, query_end: int,
           query_winnow_start: int, query_winnow_end: int,
           ref_hash: MinimizerIndex, ref_start: int, ref_end: int,
           ref_winnow_start: int, ref_winnow_end: int,
           same_genome: bool, cfg: Config) -> Hit:
    """Greedy 3-mode window growth under the Jaccard gate
    (search.cc:95-259)."""
    qmin, rmin = query_hash, ref_hash
    qlen, rlen = len(qmin.seq), len(rmin.seq)
    nq, nr = len(qmin.keys), len(rmin.keys)
    st = {"qs": query_start, "qe": query_end, "rs": ref_start, "re": ref_end,
          "qws": query_winnow_start, "qwe": query_winnow_end,
          "rws": ref_winnow_start, "rwe": ref_winnow_end}

    def q_right():
        if st["qwe"] >= nq:
            return False
        winnow.add_to_query(int(qmin.keys[st["qwe"]]))
        st["qwe"] += 1
        st["qe"] = int(qmin.locs[st["qwe"]]) if st["qwe"] < nq else qlen
        return True

    def undo_q_right():
        st["qwe"] -= 1
        winnow.remove_from_query(int(qmin.keys[st["qwe"]]))
        st["qe"] = int(qmin.locs[st["qwe"]])

    def r_right():
        if st["rwe"] >= nr:
            return False
        winnow.add_to_reference(int(rmin.keys[st["rwe"]]))
        st["rwe"] += 1
        st["re"] = int(rmin.locs[st["rwe"]]) if st["rwe"] < nr else rlen
        return True

    def undo_r_right():
        st["rwe"] -= 1
        winnow.remove_from_reference(int(rmin.keys[st["rwe"]]))
        st["re"] = int(rmin.locs[st["rwe"]])

    def both_right():
        if st["rwe"] >= nr or st["qwe"] >= nq:
            return False
        r = q_right()
        r &= r_right()
        return r

    def undo_both_right():
        undo_r_right()
        undo_q_right()

    def q_left():
        if not st["qws"]:
            return False
        st["qws"] -= 1
        winnow.add_to_query(int(qmin.keys[st["qws"]]))
        st["qs"] = int(qmin.locs[st["qws"] - 1]) + 1 if st["qws"] else 0
        return True

    def undo_q_left():
        st["qs"] = int(qmin.locs[st["qws"]]) + 1
        winnow.remove_from_query(int(qmin.keys[st["qws"]]))
        st["qws"] += 1

    def r_left():
        if not st["rws"]:
            return False
        st["rws"] -= 1
        winnow.add_to_reference(int(rmin.keys[st["rws"]]))
        st["rs"] = int(rmin.locs[st["rws"] - 1]) + 1 if st["rws"] else 0
        return True

    def undo_r_left():
        st["rs"] = int(rmin.locs[st["rws"]]) + 1
        winnow.remove_from_reference(int(rmin.keys[st["rws"]]))
        st["rws"] += 1

    def both_left():
        if not st["qws"] or not st["rws"]:
            return False
        r = q_left()
        r &= r_left()
        return r

    def undo_both_left():
        undo_r_left()
        undo_q_left()

    def both_both():
        if not st["qws"] or not st["rws"]:
            return False
        if st["rwe"] >= nr or st["qwe"] >= nq:
            return False
        r = both_left()
        r &= both_right()
        return r

    def undo_both_both():
        undo_both_right()
        undo_both_left()

    extensions = [(both_both, undo_both_both), (both_right, undo_both_right),
                  (both_left, undo_both_left)]

    # snap to winnow boundaries first (search.cc:206-217)
    st["qs"] = int(qmin.locs[st["qws"] - 1]) + 1 if st["qws"] else 0
    st["qe"] = int(qmin.locs[st["qwe"]]) if st["qwe"] < nq else qlen
    st["rs"] = int(rmin.locs[st["rws"] - 1]) + 1 if st["rws"] else 0
    st["re"] = int(rmin.locs[st["rwe"]]) if st["rwe"] < nr else rlen

    max_gap_error = cfg.search.max_error - cfg.search.max_edit_error
    while True:
        if same_genome:
            max_match = min(cfg.search.max_sd_size,
                            int((1.0 / max_gap_error + .5)
                                * abs(st["qs"] - st["rs"])))
        else:
            max_match = cfg.search.max_sd_size
        aln_len = max(st["qe"] - st["qs"], st["re"] - st["rs"])
        seq_len = min(st["qe"] - st["qs"], st["re"] - st["rs"])
        if (aln_len > max_match
                or 100.0 * seq_len / aln_len < 100 * (1 - 2 * max_gap_error)):
            break
        if same_genome:
            overlap = st["qe"] - st["rs"]
            if (overlap > 0 and 100.0 * overlap / (st["re"] - st["rs"])
                    > 100 * cfg.search.max_error):
                break
        extended = False
        for do, undo in extensions:
            if not do():
                continue
            if winnow.jaccard() >= 0:
                extended = True
                break
            undo()
        if not extended:
            break

    return Hit(SeqRef(qmin.seq.name, qmin.seq.is_rc, qlen),
               st["qs"], st["qe"],
               SeqRef(rmin.seq.name, rmin.seq.is_rc, rlen),
               st["rs"], st["re"],
               jaccard=winnow.jaccard(), name="", comment="OK")


def search_in_reference_interval(query_start, query_winnow_start,
                                 query_winnow_end, query_hash: MinimizerIndex,
                                 ref_hash: MinimizerIndex, tree: HitTree,
                                 same_genome, init_len, allow_extend,
                                 report_fails, winnow: SlidingJaccard,
                                 t_start, t_end, cfg: Config) -> list[Hit]:
    """search.cc:263-391"""
    assert t_start <= t_end and t_start >= 0
    assert winnow.query_size > 0
    filt.COUNTERS.add("total")

    rlen = len(ref_hash.seq)
    nr = len(ref_hash.keys)
    ref_start = t_start
    ref_end = min(t_start + init_len, rlen)
    ref_winnow_start = ref_hash.find_minimizers(ref_start)
    assert ref_winnow_start < nr
    ref_winnow_end = ref_winnow_start
    while (ref_winnow_end < nr
           and ref_hash.locs[ref_winnow_end] < ref_end):
        winnow.add_to_reference(int(ref_hash.keys[ref_winnow_end]))
        ref_winnow_end += 1

    # Roll to the best initial position (search.cc:287-315).  Reference
    # quirks reproduced: best coords are recorded PRE-increment (one less
    # than the window the sketch then describes), and the scan's FINAL
    # coords feed the pre-extend filter.  Instead of copying the sketch on
    # every improvement, we remember the round count and replay once.
    init_state = (winnow.copy(), ref_start, ref_end,
                  ref_winnow_start, ref_winnow_end)
    best = (winnow.jaccard(), ref_start, ref_end,
            ref_winnow_start, ref_winnow_end, 0)
    steps = 0
    while ref_start < t_end and ref_end < rlen:
        if (ref_winnow_start < nr
                and ref_hash.locs[ref_winnow_start] < ref_start + 1):
            winnow.remove_from_reference(int(ref_hash.keys[ref_winnow_start]))
            ref_winnow_start += 1
        if (ref_winnow_end < nr
                and ref_hash.locs[ref_winnow_end] == ref_end):
            winnow.add_to_reference(int(ref_hash.keys[ref_winnow_end]))
            ref_winnow_end += 1
        steps += 1
        if winnow.jaccard() > best[0]:
            best = (winnow.jaccard(), ref_start, ref_end,
                    ref_winnow_start, ref_winnow_end, steps)
        ref_start += 1
        ref_end += 1
        if ref_end == rlen:
            break
    final_rs, final_re = ref_start, ref_end  # post-increment scan exit

    # replay the initial state to the best round to recover its sketch
    best_j, best_rs, best_re, best_rws, best_rwe, best_steps = best
    winnow, ref_start, ref_end, ref_winnow_start, ref_winnow_end = init_state
    for _ in range(best_steps):
        if (ref_winnow_start < nr
                and ref_hash.locs[ref_winnow_start] < ref_start + 1):
            winnow.remove_from_reference(int(ref_hash.keys[ref_winnow_start]))
            ref_winnow_start += 1
        if (ref_winnow_end < nr
                and ref_hash.locs[ref_winnow_end] == ref_end):
            winnow.add_to_reference(int(ref_hash.keys[ref_winnow_end]))
            ref_winnow_end += 1
        ref_start += 1
        ref_end += 1
    if best_steps:
        ref_start -= 1
        ref_end -= 1
    assert (ref_start, ref_end) == (best_rs, best_re)
    assert winnow.jaccard() == best_j
    assert (ref_winnow_start, ref_winnow_end) == (best_rws, best_rwe)

    qlen = len(query_hash.seq)
    qname = SeqRef(query_hash.seq.name, query_hash.seq.is_rc, qlen)
    rname = SeqRef(ref_hash.seq.name, ref_hash.seq.is_rc, rlen)
    hits: list[Hit] = []

    if winnow.jaccard() < 0:
        filt.COUNTERS.add("jaccard")
        if report_fails:
            hits.append(Hit(
                qname, query_start, query_start + init_len, rname,
                ref_start, ref_end, jaccard=winnow.jaccard(), name="",
                comment=f"jaccard: {winnow.limit + winnow.jaccard()} < "
                        f"{winnow.limit}"))
    elif allow_extend:
        if not is_overlap(tree, query_start, query_start + init_len,
                          ref_start, ref_end, cfg):
            # search.cc:337-338: the pre-extend filter (and its fail hit)
            # use the scan's FINAL coordinates, not the best window.
            ok, reason = filt.filter_hit(query_hash.seq, query_start,
                                         query_start + init_len,
                                         ref_hash.seq, final_rs, final_re,
                                         cfg)
            if not ok:
                if report_fails:
                    hits.append(Hit(qname, query_start,
                                    query_start + init_len, rname,
                                    final_rs, final_re, jaccard=0,
                                    name="", comment=reason))
            else:
                h = extend(winnow, query_hash, query_start,
                           query_start + init_len, query_winnow_start,
                           query_winnow_end, ref_hash, ref_start, ref_end,
                           ref_winnow_start, ref_winnow_end, same_genome,
                           cfg)
                ok, reason = filt.filter_hit(
                    query_hash.seq, h.query_start, h.query_end,
                    ref_hash.seq, h.ref_start, h.ref_end, cfg)
                if not ok:
                    if report_fails:
                        h.comment = reason
                        hits.append(h)
                else:
                    hits.append(h)
                    tree.add(h.query_start, h.query_end,
                             h.ref_start, h.ref_end)
        else:
            filt.COUNTERS.add("interval")
    else:
        ok, reason = filt.filter_hit(query_hash.seq, query_start,
                                     query_start + init_len,
                                     ref_hash.seq, ref_start, ref_end, cfg)
        if ok or report_fails:
            hits.append(Hit(qname, query_start, query_start + init_len,
                            rname, ref_start, ref_end,
                            jaccard=winnow.jaccard(), name="",
                            comment="OK_INIT" if ok else reason))
    return hits


def search(query_winnow_start: int, query_hash: MinimizerIndex,
           ref_hash: MinimizerIndex, tree: HitTree, same_genome: bool,
           init_len: int, allow_extend: bool, report_fails: bool,
           cfg: Config = DEFAULT) -> list[Hit]:
    """search.cc:395-471"""
    nq = len(query_hash.keys)
    if query_winnow_start >= nq:
        return []
    query_start = int(query_hash.locs[query_winnow_start])
    if query_start + init_len > len(query_hash.seq):
        return []

    assert query_hash.kmer_size == ref_hash.kmer_size
    init_winnow = SlidingJaccard(query_hash.kmer_size, cfg)
    candidates_set: set[int] = set()
    qwe = query_winnow_start
    while (qwe < nq
           and query_hash.locs[qwe] - query_start <= init_len):
        key = int(query_hash.keys[qwe])
        init_winnow.add_to_query(key)
        qwe += 1
        if (cfg.internal.do_uppercase_seeds
                and query_hash.status_of(key) != STATUS_HAS_UPPERCASE):
            continue
        sz = ref_hash.posting_size(key)
        if sz == 0 or sz >= ref_hash.threshold:
            continue
        qloc = int(query_hash.locs[qwe - 1])
        for pos in ref_hash.posting(key):
            pos = int(pos)
            if not same_genome or pos >= query_start + init_len:
                if not tree.covers(qloc, pos):
                    candidates_set.add(pos)
    if not init_winnow.query_size:
        return []

    candidates = sorted(candidates_set)
    T: list[list[int]] = []
    limit = int(init_winnow.limit)
    for i in range(0, len(candidates) - limit + 1):
        j = i + limit - 1
        if candidates[j] - candidates[i] <= init_len:
            x = max(0, candidates[j] - init_len + 1)
            y = candidates[i] + 1
            if T and x < T[-1][1]:
                T[-1][1] = max(T[-1][1], y)
            else:
                T.append([x, y])

    hits: list[Hit] = []
    for t in T:
        if same_genome:
            t[0] = max(t[0], query_start + init_len)
        if t[0] > t[1]:
            continue
        hh = search_in_reference_interval(
            query_start, query_winnow_start, qwe, query_hash, ref_hash,
            tree, same_genome, init_len, allow_extend, report_fails,
            init_winnow.copy(), t[0], t[1], cfg)
        hits.extend(hh)

    tree.prune(query_start - cfg.search.min_read_size)
    return parse_hits(hits)


# Device roll dispatch threshold (total ladder-eligible roll steps per
# chromosome pair).  DEFAULT: disabled.  The exact sliding-sketch replay
# is O(W) vector lanes per step against the scalar engine's amortized O(1)
# ordered-map ops, plus T-class padding; its rate on a GPU is not measured
# (ROADMAP S5/T4).  The machinery stays (byte-identical, tested — see
# ops/roll_engine.py and tests/test_roll_engine.py); enable with
# SEDEF_ROLL_DEVICE_MIN_STEPS.
ROLL_DEVICE_MIN = int(__import__("os").environ.get(
    "SEDEF_ROLL_DEVICE_MIN_STEPS", 1 << 60))

# Recompute-wide device PREFILTER (ops/prefilter.py): default OFF
# (opt-in with SEDEF_PREFILTER=1).  It proves ~half the planned intervals
# dead on the device so the host skips their rolls; on dense repeats the
# phase-A span bound prunes little because interval clustering already
# guarantees >= limit shared loci, so the cost is in the composition
# rows.  Whether it pays on a GPU is not measured (ROADMAP S4).  The
# machinery stays byte-identical and fully tested
# (tests/test_prefilter.py).  NOTE: the sharded stage-1 default
# (pipeline.search_stage shard_bp) never dispatches device engines —
# opting in also requires SEDEF_SHARD_BP=0 (the whole-job path).
PREFILTER_ON = __import__("os").environ.get("SEDEF_PREFILTER", "") != ""

# dispatch floor, in planned roll steps per chromosome pair: below it the
# host rolls are cheaper than a device dispatch, and pairs stay host-only.
# devcal.apply() rescales it from the measured dispatch latency; override
# with SEDEF_PREFILTER_MIN_STEPS.
PREFILTER_MIN_STEPS = int(__import__("os").environ.get(
    "SEDEF_PREFILTER_MIN_STEPS", 1 << 20))


_ROLL_ENGINES: dict = {}
_PREFILTERS: dict = {}


def _device_prefilter_dispatch(query_hash: MinimizerIndex,
                               ref_hash: MinimizerIndex, plan, cfg: Config):
    """Launch (async) the batched roll-fail proofs for a speculative plan
    (native sedef_search_plan).  The returned PendingPrefilter's
    ``collect()`` yields (best_j, best_steps, ok) in the native results
    contract: intervals with ok and best_j < 0 are proven Jaccard fails
    (skipped without rolling); ok=False intervals roll on host."""
    import numpy as np

    from ..ops.prefilter import RollPrefilter
    from ..ops.stat_model import relaxed_jaccard_table

    win, iv = plan
    k = cfg.search.kmer_size
    pf = _PREFILTERS.get((k, cfg.search.min_read_size, id(cfg)))
    if pf is None:
        pf = RollPrefilter(k, relaxed_jaccard_table(320, k, cfg),
                           cfg.search.min_read_size)
        _PREFILTERS[(k, cfg.search.min_read_size, id(cfg))] = pf
    qk, _ = query_hash.device_arrays()
    rk, _ = ref_hash.device_arrays()
    woff = np.repeat(np.arange(len(win)), win[:, 3])
    return pf.dispatch(qk, rk, ref_hash.locs,
                       win[woff, 1], win[woff, 2],
                       iv[:, 0], iv[:, 2], iv[:, 4])


def _device_prefilter_results(query_hash: MinimizerIndex,
                              ref_hash: MinimizerIndex, plan, cfg: Config):
    """Blocking variant of :func:`_device_prefilter_dispatch`."""
    return _device_prefilter_dispatch(query_hash, ref_hash, plan,
                                      cfg).collect()


def _device_roll_results(query_hash: MinimizerIndex,
                         ref_hash: MinimizerIndex, plan, cfg: Config):
    """Run the batched device roll engine over a speculative plan
    (native sedef_search_plan).  Returns (best_j, best_steps, ok)."""
    import numpy as np

    from ..ops.roll_engine import RollEngine
    from ..ops.stat_model import relaxed_jaccard_estimate

    win, iv = plan
    k = cfg.search.kmer_size
    eng = _ROLL_ENGINES.get((k, id(cfg)))
    if eng is None:
        lut = np.array([relaxed_jaccard_estimate(s, k, cfg)
                        for s in range(161)], np.int32)
        eng = RollEngine(k, lut)
        _ROLL_ENGINES[(k, id(cfg))] = eng
    qk, _ = query_hash.device_arrays()
    rk, rl = ref_hash.device_arrays()
    # per-interval window columns
    woff = np.repeat(np.arange(len(win)), win[:, 3])
    qws = win[woff, 1]
    qwe = win[woff, 2]
    return eng.run(qk, rk, rl, len(ref_hash.keys), len(ref_hash.seq),
                   qws, qwe, iv[:, 0], iv[:, 2], iv[:, 3], iv[:, 4],
                   iv[:, 5])


class PreparedSearch:
    """Phase-1 product of the native+device search: the speculative plan
    plus the (possibly in-flight) device verdicts.  ``finish()`` blocks on
    the device and returns (plan, results) for native ``sedef_search``."""

    __slots__ = ("plan", "results", "pending", "mode", "_names", "_steps")

    def __init__(self, plan, results, pending, mode, names, steps):
        self.plan = plan
        self.results = results
        self.pending = pending
        self.mode = mode
        self._names = names
        self._steps = steps

    def finish(self):
        if self.pending is not None:
            self.results = self.pending.collect()
            self.pending = None
        from ..debug import dprn
        dprn("[seeder] {} vs {}: plan {} windows / {} intervals, "
             "{} roll steps -> {}{}",
             self._names[0], self._names[1],
             len(self.plan[0]) if self.plan is not None else 0,
             self._steps[0], self._steps[1], self.mode,
             " ({} pruned)".format(int(self.results[2].sum()))
             if self.mode == "prefilter" else "")
        return self.plan, self.results


def prepare_device_search(query_hash: MinimizerIndex,
                          ref_hash: MinimizerIndex, is_same_genome: bool,
                          cfg: Config = DEFAULT,
                          use_device: bool | None = None
                          ) -> "PreparedSearch | None":
    """Build the stage-1 speculative plan and LAUNCH the device prefilter
    dispatches without blocking.  Callers (search_job) prepare every
    chromosome pair of a pair job first, so each pair's device round
    trips overlap the host planning and native searching of the
    others.  Returns None when the native+device path is inactive (the
    caller falls back to the self-contained initial_search flow)."""
    import os
    if os.environ.get("SEDEF_NO_NATIVE", ""):
        return None
    try:
        from ..native import lib as _native
    except Exception:  # pragma: no cover
        return None
    if (_native is None or not _native.has("search")
            or not _native.has("search_plan")):
        return None  # pragma: no cover
    if use_device is None:
        from .pipeline import auto_device
        use_device = auto_device()
    if not use_device or cfg.search.kmer_size > 14:
        return None
    roll_enabled = ROLL_DEVICE_MIN < (1 << 60)
    if not roll_enabled and not PREFILTER_ON:
        # nothing would consume the speculative plan — skip it (the
        # plan's collect/cluster pass costs ~25% of a pair job's native
        # search time, pure overhead when no device engine is active)
        return None

    from ..ops.roll_engine import T_PAD_LADDER
    plan = _native.search_plan(query_hash, ref_hash, is_same_genome, cfg)
    steps = plan[1][:, 4]
    total_steps = int(steps.sum())
    names = (query_hash.seq.name, ref_hash.seq.name)
    # the exact replay engine only pays off when explicitly enabled
    # (SEDEF_ROLL_DEVICE_MIN_STEPS); it is capped by its T-class ladder
    # AND k <= 13 (packed flag bits)
    eligible = int(steps[steps <= T_PAD_LADDER[-1]].sum())
    if (len(plan[1]) and cfg.search.kmer_size <= 13
            and eligible >= ROLL_DEVICE_MIN):
        results = _device_roll_results(query_hash, ref_hash, plan, cfg)
        return PreparedSearch(plan, results, None, "device-roll", names,
                              (len(steps), total_steps))
    if (len(plan[1]) and PREFILTER_ON
            and total_steps >= PREFILTER_MIN_STEPS):
        pending = _device_prefilter_dispatch(query_hash, ref_hash, plan,
                                             cfg)
        return PreparedSearch(plan, None, pending, "prefilter", names,
                              (len(steps), total_steps))
    return PreparedSearch(None, None, None, "host", names,
                          (len(steps), total_steps))


def shard_bounds(query_hash: MinimizerIndex, n_shards: int) -> list[int]:
    """Split the query minimizer index range into ~equal-bp spans.

    Returns C+1 ascending minimizer indices (C <= n_shards after
    deduplication); shard c scans [bounds[c], bounds[c+1])."""
    qlen = len(query_hash.seq)
    nq = len(query_hash.keys)
    bounds = [0]
    for s in range(1, n_shards):
        b = query_hash.find_minimizers(qlen * s // n_shards)
        if b > bounds[-1]:
            bounds.append(b)
    if nq > bounds[-1]:
        bounds.append(nq)
    return bounds


class ShardedPairSearch:
    """Byte-identical ``initial_search`` via speculative query-range
    shards — the fine-grained stage-1 work unit for multi-worker /
    multi-chip load balance (the reference's balance comes from ~600
    whole-pair processes, sedef.sh:133-140; a single heavy pair like a
    chr1 self-search needs sub-pair units).

    The native core's only cross-window state is (stride position, dedup
    tree); ``sedef_search_range`` exposes both as an explicit interface.
    Shards first run SPECULATIVELY in parallel with a guessed empty
    incoming state (``submit_round1``), then a fixpoint loop
    (``finish``) reruns exactly those shards whose true incoming state
    (the previous shard's outgoing) differs from their guess, until no
    interface changes.  At the fixpoint the chained outputs equal the
    sequential run byte for byte (induction: shard 0's guess is always
    true; once shards < c are exact, shard c's incoming is the true
    one).  Worst case (every boundary carries live state, e.g. dense
    tandem repeats) degrades to ~2x the sequential work, still spread
    over the workers.

    Two-phase API so a stage driver can pre-submit round 1 for EVERY
    chromosome pair before finishing any (cross-pair overlap)."""

    def __init__(self, query_hash: MinimizerIndex,
                 ref_hash: MinimizerIndex, is_same_genome: bool,
                 cfg: Config = DEFAULT, n_shards: int = 8,
                 run_wrap=None):
        import numpy as np
        self.qh = query_hash
        self.rh = ref_hash
        self.same = is_same_genome
        self.cfg = cfg
        self.bounds = shard_bounds(query_hash, n_shards)
        self.C = len(self.bounds) - 1
        self._empty = np.empty((0, 4), np.int32)
        self._futs = None
        # run_wrap(fn, unit_idx) -> result: lets the scheduler pin a
        # device / account time around each unit execution
        self._wrap = run_wrap

    def _run(self, c: int, nxt: int, tree):
        import time as _time

        from ..native import lib as _native

        def body():
            return _native.search_range(
                self.qh, self.rh, self.same, self.cfg,
                self.bounds[c], self.bounds[c + 1], nxt, tree)

        t0 = _time.perf_counter()
        r = body() if self._wrap is None else self._wrap(body, c)
        return r, _time.perf_counter() - t0

    def unit_costs(self) -> list[float]:
        """Scheduler cost model per shard: query-span bp x ref bp (the
        align stage's complexity model applied to seed search)."""
        locs = self.qh.locs
        nq = len(locs)
        rl = float(len(self.rh.seq))
        out = []
        for c in range(self.C):
            lo = int(locs[self.bounds[c]]) if self.bounds[c] < nq else 0
            hi = (int(locs[self.bounds[c + 1]])
                  if self.bounds[c + 1] < nq else len(self.qh.seq))
            out.append(float(max(hi - lo, 1)) * rl)
        return out

    def submit_round1(self, submit, unit_times: list | None = None):
        """Launch every shard with the speculative empty incoming state.
        ``submit(fn, *args)`` returns a future (None runs inline)."""
        if submit is None:
            self._futs = [self._run(c, 0, self._empty)
                          for c in range(self.C)]
        else:
            self._futs = [submit(self._run, c, 0, self._empty)
                          for c in range(self.C)]
        self._unit_times = unit_times
        return self

    def finish(self, submit=None) -> list[Hit]:
        """Fixpoint + assembly; blocks on the round-1 futures."""
        import numpy as np

        if self.C < 1:
            return []
        if self._futs is None:
            self.submit_round1(submit)

        def wait(x):
            return x.result() if hasattr(x, "result") else x

        round1 = [wait(f) for f in self._futs]
        results = [r for r, _ in round1]
        used = [(0, self._empty)] * self.C
        if self._unit_times is not None:
            self._unit_times.extend(dt for _, dt in round1)

        # Interface SANITIZATION (the rerun killer): a dedup rectangle
        # with qe <= the shard's first minimizer locus is INERT — every
        # window the shard processes has query_start >= that locus, so
        # tree_covers / is_overlap probes (qs <= q < qe) can never match
        # it, it contributes nothing to pruning decisions, and it stays
        # inert for every later shard (loci ascend).  Likewise an
        # incoming stride position <= the first locus skips nothing.
        # Dropping both from the interface is therefore behavior- and
        # output-invariant (by induction over shards), and it is what
        # keeps the speculative empty-state guess exact on sparse
        # genomes: unpruned rectangles LINGER in the sequential tree far
        # past their live range (pruning only happens at did_work
        # windows), and without sanitization nearly every shard's true
        # incoming differs from the guess, degrading the fixpoint to
        # ~2x sequential work (measured on 125 Mbp chromosomes).
        locs = self.qh.locs
        nq = len(locs)
        first_loc = [int(locs[self.bounds[c]]) if self.bounds[c] < nq
                     else (1 << 30) for c in range(self.C)]

        def sanitize(c, nxt, tree):
            fl = first_loc[c]
            nxt = nxt if nxt > fl else 0
            if len(tree):
                tree = tree[tree[:, 1] > fl]
            else:
                tree = self._empty
            return nxt, tree

        while True:
            incoming = [(0, self._empty)]
            for c in range(self.C - 1):
                incoming.append(sanitize(c + 1, results[c][1],
                                         results[c][2]))
            stale = [c for c in range(self.C)
                     if used[c][0] != incoming[c][0]
                     or not np.array_equal(used[c][1], incoming[c][1])]
            if not stale:
                break
            # reruns execute INLINE on the consumer thread: with a shared
            # pool, queued round-1 units of LATER pairs already occupy
            # the workers, so a submitted rerun would wait at the back of
            # the queue and serialize every pair's completion behind the
            # whole stage's round 1 (measured: first progress line after
            # ~15 min on a 3 Gbp genome).  Inline reruns overlap with the
            # workers' round-1 stream instead.
            redone = [self._run(c, *incoming[c]) for c in stale]
            for c, (r, _) in zip(stale, redone):
                results[c] = r
                used[c] = incoming[c]

        from ..ops import filter as filt
        qref = SeqRef(self.qh.seq.name, self.qh.seq.is_rc,
                      len(self.qh.seq))
        rref = SeqRef(self.rh.seq.name, self.rh.seq.is_rc,
                      len(self.rh.seq))
        out: list[Hit] = []
        tot = np.zeros(5, np.int64)
        for hits, _, _, counters in results:
            tot += counters
            for qs, qe, rs, re_, jac in hits:
                out.append(Hit(SeqRef(qref.name, qref.is_rc, qref.length),
                               int(qs), int(qe),
                               SeqRef(rref.name, rref.is_rc, rref.length),
                               int(rs), int(re_), jaccard=int(jac),
                               name="", comment="OK"))
        for key, idx in zip(("total", "jaccard", "interval", "lowercase",
                             "qgram"), range(5)):
            filt.COUNTERS.add(key, int(tot[idx]))
        return out


def sharded_pair_search(query_hash: MinimizerIndex,
                        ref_hash: MinimizerIndex, is_same_genome: bool,
                        cfg: Config = DEFAULT, n_shards: int = 8,
                        submit=None, unit_times: list | None = None
                        ) -> list[Hit]:
    """One-shot wrapper over :class:`ShardedPairSearch`."""
    sps = ShardedPairSearch(query_hash, ref_hash, is_same_genome, cfg,
                            n_shards)
    sps.submit_round1(submit, unit_times)
    return sps.finish(submit)


def initial_search(query_hash: MinimizerIndex, ref_hash: MinimizerIndex,
                   is_same_genome: bool, cfg: Config = DEFAULT,
                   report=None, use_native: bool | None = None,
                   report_fails: bool = False,
                   use_device: bool | None = None,
                   prepared: "PreparedSearch | None" = None) -> list[Hit]:
    """search_main.cc:40-82 — the per-chromosome-pair driver.

    Dispatches to the C++ native core (native/native.cc sedef_search —
    parity-tested against this implementation) unless disabled.  With
    ``use_device`` the roll-to-best scans (search.cc:289-315, the
    reference's hottest loop) run batched on the device (ops/roll_engine.py)
    and the native core consumes the verdicts; output is byte-identical.
    ``report_fails`` emits diagnostic rows for windows rejected by the
    Jaccard / interval / uppercase / q-gram gates (search.cc fail hits);
    it always runs the Python engine, which carries the fail comments."""
    if use_native is None:
        import os
        use_native = os.environ.get("SEDEF_NO_NATIVE", "") == ""
    if report_fails:
        use_native = False
    if use_device is None:
        from .pipeline import auto_device
        use_device = auto_device()
    if use_native:
        try:
            from ..native import lib as _native
        except Exception:  # pragma: no cover
            _native = None
        if _native is not None and _native.has("search"):
            if prepared is None:
                prepared = prepare_device_search(
                    query_hash, ref_hash, is_same_genome, cfg, use_device)
            plan = results = None
            if prepared is not None:
                plan, results = prepared.finish()
            rows = _native.search(query_hash, ref_hash, is_same_genome,
                                  cfg, plan=plan, results=results)
            qref = SeqRef(query_hash.seq.name, query_hash.seq.is_rc,
                          len(query_hash.seq))
            rref = SeqRef(ref_hash.seq.name, ref_hash.seq.is_rc,
                          len(ref_hash.seq))
            out = []
            for qs, qe, rs, re_, jac in rows:
                h = Hit(SeqRef(qref.name, qref.is_rc, qref.length),
                        int(qs), int(qe),
                        SeqRef(rref.name, rref.is_rc, rref.length),
                        int(rs), int(re_), jaccard=int(jac), name="",
                        comment="OK")
                out.append(h)
                if report:
                    report(h)
            return out

    tree = HitTree()
    out: list[Hit] = []
    next_to_attain = 0
    min_read = cfg.search.min_read_size
    for qi in range(len(query_hash.keys)):
        loc = int(query_hash.locs[qi])
        if loc < next_to_attain:
            continue
        if (cfg.internal.do_uppercase_seeds
                and query_hash.status_of(int(query_hash.keys[qi]))
                != STATUS_HAS_UPPERCASE):
            continue
        hits = search(qi, query_hash, ref_hash, tree, is_same_genome,
                      min_read, True, report_fails, cfg)
        min_len = len(query_hash.seq)
        for h in hits:
            # fail rows (report_fails) flow through min_len/stride exactly
            # like real hits — the reference's loop makes no distinction
            # (search_main.cc:68-79)
            min_len = min(min_len, h.query_end - h.query_start)
            out.append(h)
            if report:
                report(h)
        next_to_attain = (loc + int(min_read * cfg.search.max_error) // 2
                          if min_len >= min_read else loc)
    return out
