"""End-to-end SD pipeline: search -> bucket -> align -> stats -> final.bed.

In-process equivalent of the reference bash driver (``sedef.sh``) plus the
align/bucket/stats subcommand drivers (``src/align_main.cc``,
``src/stats_main.cc``).  Stage boundaries remain file-compatible BED so every
intermediate is diffable against the reference pipeline's
``seeds.bed`` / ``aligned.bed`` / ``final.bed``.

Coordinates are chromosomal everywhere: the super-bins of
``generate_translation`` only group chromosomes into jobs
(search_main.cc:143-168); the reference's ``translation_index`` remapping is
dead code (never populated) and is not replicated.
"""

from __future__ import annotations

import math
import os
import re
import sys
import time
from collections import defaultdict

from ..config import DEFAULT, Config
from ..io.bed import Hit, canonical_swap
from ..io.fasta import FastaReference, generate_translation
from ..ops.dna import PackedSeq, revcomp
from ..ops.index import MinimizerIndex
from ..ops.merge_hits import merge_hits
from ..ops.wavefront import WavefrontAligner
from . import reporter
from .aligner import fast_align
from .seeder import initial_search


def auto_device() -> bool:
    """Default for the stage-1 device ops (device index build, roll
    engine, prefilter): off.  They are plain JAX and run on any backend
    when a caller passes ``use_device=True``; whether any of them pays on
    a GPU is not measured yet (ROADMAP S4/S5)."""
    return False


def _index_nbytes(idx: MinimizerIndex) -> int:
    """Host bytes held by one cached index (sequence planes + minimizer
    arrays + posting bounds): ~350 MB per 48 Mbp chromosome strand."""
    n = 0
    for a in (idx.keys, idx.locs, idx.skeys, idx.slocs, idx._uniq,
              idx._starts, idx._ends, idx.seq.code, idx.seq.cls,
              idx.seq._seq_bytes):
        n += int(getattr(a, "nbytes", 0))
    return n


class IndexCache:
    """Per-(chromosome, strand) MinimizerIndex LRU cache shared across
    pair jobs.  The reference re-indexes in every one of its ~n(n+1)
    processes (search_main.cc:155-168); a single in-process run needs each
    chromosome indexed once per strand — but holding every strand of a
    multi-Gbp genome forever is what drove stage-1 peak RSS to 13.6 GB on
    a 1.05 Gbp run, so the cache is byte-capped (``SEDEF_INDEX_CACHE_GB``,
    default 8): least-recently-used entries are dropped and rebuilt on
    re-touch (a job's working set is the 2 super-bins in flight, well
    under the cap).  Thread-safe for the -j fan-out; an evicted index a
    running job still references stays alive through that reference."""

    def __init__(self, fr: FastaReference, cfg: Config,
                 use_device: bool | None = None,
                 max_bytes: int | None = None):
        import os
        self.fr = fr
        self.cfg = cfg
        self.use_device = auto_device() if use_device is None else use_device
        if max_bytes is None:
            max_bytes = int(float(os.environ.get(
                "SEDEF_INDEX_CACHE_GB", "8")) * (1 << 30))
        self.max_bytes = max_bytes
        from collections import OrderedDict
        self._cache: OrderedDict[tuple[str, bool], MinimizerIndex] = \
            OrderedDict()
        self._bytes = 0
        self.evictions = 0
        import threading
        self._lock = threading.Lock()
        self._building: dict[tuple[str, bool], object] = {}

    def get(self, name: str, is_rc: bool) -> MinimizerIndex:
        import threading
        key = (name, is_rc)
        with self._lock:
            idx = self._cache.get(key)
            if idx is not None:
                self._cache.move_to_end(key)
                return idx
            ev = self._building.get(key)
            if ev is None:
                ev = threading.Event()
                self._building[key] = ev
                builder = True
            else:
                builder = False
        if not builder:
            ev.wait()
            with self._lock:
                idx = self._cache.get(key)
                if idx is not None:
                    return idx
            # built entry was evicted before we woke: build our own copy
            return MinimizerIndex(
                PackedSeq(name, self.fr.get_sequence(name), is_rc=is_rc),
                self.cfg.search.kmer_size, self.cfg.search.window_size,
                use_device=self.use_device)
        idx = MinimizerIndex(
            PackedSeq(name, self.fr.get_sequence(name), is_rc=is_rc),
            self.cfg.search.kmer_size, self.cfg.search.window_size,
            use_device=self.use_device)
        with self._lock:
            self._cache[key] = idx
            self._bytes += _index_nbytes(idx)
            del self._building[key]
            while self._bytes > self.max_bytes and len(self._cache) > 1:
                old_key, old = self._cache.popitem(last=False)
                self._bytes -= _index_nbytes(old)
                self.evictions += 1
        ev.set()
        return idx


def search_job(fr: FastaReference, query_chrs: list[str],
               ref_chrs: list[str], is_rc: bool, cfg: Config = DEFAULT,
               use_device: bool | None = None,
               cache: "IndexCache | None" = None,
               report_fails: bool = False) -> list[str]:
    """One stage-1 job: all query x ref chromosome pairs of two super-bins
    on one strand (search_main.cc:122-196).  Returns seed BED lines.
    ``report_fails`` adds diagnostic rows for gate-rejected windows."""
    if cache is None:
        cache = IndexCache(fr, cfg, use_device)
    pairs = []
    for r in ref_chrs:
        rh = cache.get(r, is_rc)
        for q in query_chrs:
            qh = cache.get(q, False)
            pairs.append((qh, rh, (q == r) and not is_rc))

    # two-phase device overlap: plan + LAUNCH the prefilter dispatches for
    # every chromosome pair first (prepare_device_search is async), then
    # collect + search in order — pair k's device round trips run
    # under pair k+1's host planning and pair k-1's native search instead
    # of serializing with them
    prepared = [None] * len(pairs)
    if cache.use_device and not report_fails:
        from .seeder import prepare_device_search
        prepared = [prepare_device_search(qh, rh, sg, cfg,
                                          use_device=cache.use_device)
                    for qh, rh, sg in pairs]

    lines: list[str] = []
    for (qh, rh, same_genome), prep in zip(pairs, prepared):
        hits = initial_search(qh, rh, same_genome, cfg,
                              report_fails=report_fails,
                              use_device=cache.use_device, prepared=prep)
        lines.extend(h.to_bed() for h in hits)
    return lines


def _search_stage_sharded(fr, bins, cfg, cache, todo, shard_bp, jobs,
                          progress, sink, device_assignment,
                          unit_report: list | None = None
                          ) -> "list[str] | int":
    """Fine-grained stage 1: every chromosome pair is split into
    ~shard_bp query-range shards (seeder.ShardedPairSearch), round-1
    units are submitted to one pool in a bounded PAIR WINDOW ahead of
    the in-order consumer, and pairs are finished (fixpoint + assembly)
    in deterministic job order.  Output is byte-identical to the
    unsharded stage (tests/test_shard_search.py).

    The schedulable unit shrinks from a whole pair job to a query-range
    shard — the reference gets its balance from ~600 whole-pair
    processes (sedef.sh:133-140); one heavy self-search pair needs
    sub-pair units.  Pair state (index references + completed seed
    lists) exists only inside the submission window
    (``SEDEF_SHARD_WINDOW_PAIRS``, default max(16, 8*jobs)), so peak
    RSS is O(window) pairs, not the whole job matrix — index builds
    happen lazily inside the window and launch on the pool itself, so
    they run in parallel and overlap the unit stream.

    ``unit_report`` (out) receives (job_idx, pair_idx, shard_idx, cost,
    round1_seconds, device) per unit; devices are assigned by LPT on the
    query-len x ref-len cost model purely as scheduling bookkeeping (the
    shard itself is native host code)."""
    from concurrent.futures import ThreadPoolExecutor

    from .seeder import ShardedPairSearch

    devices = []
    if cache.use_device:
        import jax
        devices = list(jax.devices())
    n_sched = max(len(devices), 1)

    # per-job pair descriptors + unit cost model from chromosome lengths
    # alone (no index needed: scheduling must not force index builds)
    desc: list[list[tuple[str, str, bool, bool, int]]] = []
    units: list[tuple[int, int, int, float]] = []
    for k, (i, j, is_rc) in enumerate(todo):
        pair_list = []
        for r in bins[j]:
            rl = float(fr.length(r))
            for q in bins[i]:
                ql = fr.length(q)
                n_sh = max(1, -(-ql // shard_bp))
                p = len(pair_list)
                pair_list.append((q, r, is_rc, (q == r) and not is_rc,
                                  n_sh))
                for c in range(n_sh):
                    units.append((k, p, c, (ql / n_sh) * rl))
        desc.append(pair_list)

    # LPT schedule of units onto the device slots (bookkeeping for
    # the balance metric; shards are native host work)
    unit_dev: dict[tuple[int, int, int], int] = {}
    loads = [0.0] * n_sched
    for k, p, c, cost in sorted(units, key=lambda u: -u[3]):
        d = min(range(n_sched), key=loads.__getitem__)
        unit_dev[(k, p, c)] = d
        loads[d] += cost
    if device_assignment is not None:
        device_assignment.extend(
            unit_dev[(k, p, c)] for k, p, c, _ in units)
    cost_of = {(k, p, c): cost for k, p, c, cost in units}

    window = int(os.environ.get("SEDEF_SHARD_WINDOW_PAIRS", "0") or 0)
    if window <= 0:
        window = max(16, 8 * jobs)

    with ThreadPoolExecutor(max_workers=jobs) as ex:
        times_of: dict[tuple[int, int], list] = {}
        launched: dict[tuple[int, int], object] = {}  # -> Future[sps]
        in_flight = 0          # pairs launched but not yet consumed
        next_job = 0           # first job with unlaunched pairs

        def launch_pair(k, p):
            q, r, is_rc, same, n_sh = desc[k][p]
            rh = cache.get(r, is_rc)
            qh = cache.get(q, False)
            sps = ShardedPairSearch(qh, rh, same, cfg, n_sh)
            sps.submit_round1(ex.submit, times_of[(k, p)])
            return sps

        def top_up():
            nonlocal in_flight, next_job
            while next_job < len(todo) and in_flight < window:
                k = next_job
                for p in range(len(desc[k])):
                    times_of[(k, p)] = []
                    launched[(k, p)] = ex.submit(launch_pair, k, p)
                in_flight += len(desc[k])
                next_job += 1

        top_up()
        lines: list[str] = []
        total = 0
        for k, (i, j, is_rc) in enumerate(todo):
            t0 = time.time()
            job_lines: list[str] = []
            for p in range(len(desc[k])):
                sps = launched.pop((k, p)).result()
                job_lines.extend(h.to_bed() for h in sps.finish(ex.submit))
            in_flight -= len(desc[k])
            top_up()
            dt = sum(sum(times_of[(k, p)]) for p in range(len(desc[k])))
            if unit_report is not None:
                for p in range(len(desc[k])):
                    for c, ut in enumerate(times_of[(k, p)]):
                        unit_report.append((k, p, c, cost_of[(k, p, c)],
                                            ut, unit_dev[(k, p, c)]))
            for p in range(len(desc[k])):
                del times_of[(k, p)]
            if sink is None:
                lines.extend(job_lines)
            else:
                sink(job_lines)
            total += len(job_lines)
            if progress:
                progress(i, j, is_rc, len(job_lines),
                         dt if dt > 0 else time.time() - t0)
    return total if sink is not None else lines


def search_stage(fr: FastaReference, bins: list[list[str]],
                 cfg: Config = DEFAULT, use_device: bool | None = None,
                 progress=None, jobs: int = 1,
                 device_assignment: list | None = None,
                 cache: "IndexCache | None" = None,
                 sink=None, shard_bp: int | None = None,
                 unit_report: list | None = None,
                 todo: "list[tuple[int, int, bool]] | None" = None
                 ) -> "list[str] | int":
    """Stage 1 over all (bin_i >= bin_j) x strand jobs (sedef.sh:133-140).

    ``jobs > 1`` fans the independent pair jobs over a thread pool (the
    GNU-Parallel equivalent; the native search core releases the GIL, so
    threads scale like the reference's processes without duplicating the
    genome per worker).  Output order stays deterministic.
    ``device_assignment`` (out-param) receives the per-job device index
    chosen by the multi-chip schedule.

    ``sink`` streams the output: it is called once per pair job, in
    deterministic job order, with that job's seed lines, and the return
    value is the total line count instead of a list — the analog of the
    reference's per-job ``seeds/{i}_{j}_{m}.bed`` redirects
    (sedef.sh:137), bounding stage-1 output memory by a 2*jobs window of
    jobs instead of the genome-wide seed set.

    ``shard_bp`` switches to the fine-grained unit scheduler
    (_search_stage_sharded): every chromosome pair splits into
    ~shard_bp query-range shards, byte-identical via the speculative
    fixpoint of seeder.ShardedPairSearch; ``unit_report`` (out) then
    receives (job, pair, shard, cost, round1_s, device) per unit.

    ``todo`` overrides the job list (a multi-host driver passes its
    slice of the global (i >= j) x strand matrix); default is the full
    matrix."""
    nbins = len(bins)
    if todo is None:
        todo = [(i, j, is_rc)
                for j in range(nbins)
                for i in range(j, nbins)
                for is_rc in (False, True)]
    if cache is None:
        cache = IndexCache(fr, cfg, use_device)

    if shard_bp is None and jobs > 1:
        # default: fine-grained units whenever a pool exists — measured
        # 22% faster on the 20 Mbp e2e spec at 2 threads (2.57 -> 2.01 s,
        # byte-identical), and the granularity the multi-chip/multi-host
        # schedules need.  SEDEF_SHARD_BP=0 restores whole-job units
        # (whose bounded submission window caps output memory at O(jobs)
        # jobs; the sharded path buffers completed pairs until their job
        # is consumed).
        shard_bp = int(os.environ.get("SEDEF_SHARD_BP", 2_000_000))
    if shard_bp:
        from ..native import lib as _native
        if _native is not None and _native.has("search_range"):
            return _search_stage_sharded(fr, bins, cfg, cache, todo,
                                         shard_bp, max(jobs, 1), progress,
                                         sink, device_assignment,
                                         unit_report)

    # multi-chip stage 1: pair jobs are assigned to local devices by a
    # longest-processing-time-first schedule on the |bin_i| x |bin_j|
    # cost model (the align stage's complexity model applied to seeding),
    # so -j threads drive every chip concurrently with balanced load
    # (index builds and prefilter batches run under each job's default
    # device; device_arrays caches per chip).  The reference's analog is
    # one PROCESS per pair job under GNU Parallel (sedef.sh:133-140);
    # here the chip is the parallel resource.
    devices = []
    if cache.use_device:
        import jax
        devices = list(jax.devices())
    rotate = len(devices) > 1
    device_of = [0] * len(todo)
    if rotate:
        sizes = [sum(fr.length(c) for c in b) for b in bins]
        cost = [float(sizes[t[0]]) * float(sizes[t[1]]) for t in todo]
        loads = [0.0] * len(devices)
        for k in sorted(range(len(todo)), key=lambda k: -cost[k]):
            d = min(range(len(devices)), key=loads.__getitem__)
            device_of[k] = d
            loads[d] += cost[k]
    if device_assignment is not None:
        device_assignment.extend(device_of)

    def timed(t, job_idx=0):
        t0 = time.time()
        if rotate:
            import jax
            with jax.default_device(devices[device_of[job_idx]]):
                out = search_job(fr, bins[t[0]], bins[t[1]], t[2], cfg,
                                 use_device, cache)
        else:
            out = search_job(fr, bins[t[0]], bins[t[1]], t[2], cfg,
                             use_device, cache)
        return out, time.time() - t0

    lines: list[str] = []
    total = 0

    def consume(results_iter):
        nonlocal total
        for (i, j, is_rc), (job, dt) in zip(todo, results_iter):
            if sink is None:
                lines.extend(job)
            else:
                sink(job)
            total += len(job)
            if progress:
                progress(i, j, is_rc, len(job), dt)

    if jobs <= 1:
        consume(timed(t, k) for k, t in enumerate(todo))
    else:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        def bounded(ex):
            # submit in a bounded window (2x the worker count): completed-
            # but-unconsumed outputs are capped at O(jobs) pair jobs even
            # when the in-order consumer blocks on a slow early job,
            # instead of the whole seed set buffering in eager futures
            window = 2 * jobs
            futs: deque = deque()
            it = iter(enumerate(todo))
            for k, t in it:
                futs.append(ex.submit(timed, t, k))
                if len(futs) >= window:
                    break
            for k, t in it:
                yield futs.popleft().result()
                futs.append(ex.submit(timed, t, k))
            while futs:
                yield futs.popleft().result()

        with ThreadPoolExecutor(max_workers=jobs) as ex:
            consume(bounded(ex))
    return total if sink is not None else lines


def _tmp_bin_name(key: tuple[int, int]) -> str:
    """Reference tmp-spill filename (align_main.cc:90-92).  The reference
    iterates its ``map<string, FILE*>`` in lexicographic order of this
    string — NOT numeric (bi, bj) order; they diverge from 10 super-bins
    up (e.g. tmp_10_0 < tmp_2_0), so both modes below sort by it."""
    return f"tmp_{key[0]}_{key[1]}.tmp"


def bucket_stage(seed_lines, fr: FastaReference,
                 bins: list[list[str]], nbuckets: int = 1000,
                 cfg: Config = DEFAULT,
                 tmp_dir: str | None = None,
                 merge_shard: tuple[int, int] | None = None,
                 merge_exchange=None) -> list[list[str]]:
    """Stage 2a (align_main.cc:38-198): extend x5/15 Kbp, canonical swap,
    per-(bin_i, bin_j) merge, complexity-stratified round-robin buckets.

    ``tmp_dir`` enables the reference's disk-spill mode
    (align_main.cc:89-106): extended hits stream to per-(bin_i, bin_j)
    tmp files and are reloaded one bin at a time, bounding peak memory by
    the largest bin instead of the whole genome's extended-hit set.
    ``seed_lines`` may be any iterable (e.g. a file line generator).

    ``merge_shard=(pid, pcount)`` restricts the per-bin merge pass to
    every pcount-th bin (the multi-process fan-out of
    parallel/distributed.py); ``merge_exchange(keys, rows_of)`` must then
    return every bin's merged rows (a DCN all-gather).  The histogram and
    round-robin bucketing run identically on every process from the
    exchanged rows, so the buckets stay byte-identical to a local run."""
    lookup: dict[str, int] = {}
    for bi, names in enumerate(bins):
        for name in names:
            lookup[name] = bi

    spill = tmp_dir is not None
    if spill:
        os.makedirs(tmp_dir, exist_ok=True)
    handles: dict[tuple[int, int], object] = {}
    tmp: dict[tuple[int, int], list[str]] = defaultdict(list)
    for line in seed_lines:
        if not line.strip():
            continue
        h, _ = Hit.from_bed(line)
        h.extend(cfg.extend.ratio, cfg.extend.max_extend)
        canonical_swap(h)
        key = (lookup[h.query.name], lookup[h.ref.name])
        # tmp rows round-trip through to_bed(False)/from_bed in the
        # reference; replicate so coordinates/strands match exactly
        row = h.to_bed(False)
        if spill:
            f = handles.get(key)
            if f is None:
                f = open(os.path.join(tmp_dir, _tmp_bin_name(key)), "w")
                handles[key] = f
            f.write(row + "\n")
        else:
            tmp[key].append(row)
    if spill:
        for f in handles.values():
            f.close()
    keys = sorted(handles if spill else tmp, key=_tmp_bin_name)

    def read_bin(key):
        if spill:
            with open(os.path.join(tmp_dir, _tmp_bin_name(key))) as f:
                return f.read().splitlines()
        return tmp[key]

    def write_bin(key, lines):
        if spill:
            with open(os.path.join(tmp_dir, _tmp_bin_name(key)), "w") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))
        else:
            tmp[key] = lines

    merged_rows: dict[tuple[int, int], list[str]] = {}
    for ki, key in enumerate(keys):
        if merge_shard is not None and ki % merge_shard[1] != merge_shard[0]:
            continue
        hits = [Hit.from_bed(r)[0] for r in read_bin(key)]
        hits = merge_hits(hits, cfg.extend.merge_dist)
        merged_rows[key] = [h.to_bed(False) for h in hits]
    if merge_exchange is not None:
        merged_rows = merge_exchange(keys, merged_rows)

    max_complexity = 0
    complexity_hist: dict[int, int] = defaultdict(int)
    for key in keys:
        rows = merged_rows[key]
        for row in rows:
            h, _ = Hit.from_bed(row)
            c = int(math.sqrt(float(h.query_end - h.query_start)
                              * float(h.ref_end - h.ref_start)))
            max_complexity = max(max_complexity, c)
            complexity_hist[c // 1000] += 1
        write_bin(key, rows)

    next_bin = [0]
    for c in range(1, max_complexity // 1000 + 1):
        next_bin.append((next_bin[c - 1] + complexity_hist[c - 1]) % nbuckets)

    buckets: list[list[str]] = [[] for _ in range(nbuckets)]
    for key in keys:
        for line in read_bin(key):
            h, _ = Hit.from_bed(line)
            c = int(math.sqrt(float(h.query_end - h.query_start)
                              * float(h.ref_end - h.ref_start))) // 1000
            b = next_bin[c]
            next_bin[c] = (next_bin[c] + 1) % nbuckets
            if h.query.is_rc:
                h.query, h.ref = h.ref, h.query
                h.query_start, h.ref_start = h.ref_start, h.query_start
                h.query_end, h.ref_end = h.ref_end, h.query_end
            buckets[b].append(h.to_bed(False))
    if spill:
        for key in keys:
            os.unlink(os.path.join(tmp_dir, _tmp_bin_name(key)))
    return buckets


def align_stage(bucket_lines: list[str], fr: FastaReference,
                cfg: Config = DEFAULT,
                aligner: WavefrontAligner | None = None,
                kmer_size: int = 11, jobs: int = 1,
                progress=None) -> list[str]:
    """Stage 2b (align_main.cc:285-337): fast_align per extended region,
    coordinates lifted back to chromosome space.

    ``jobs > 1`` runs regions on a thread pool with a coalescing aligner:
    concurrent gap-alignment batches merge into single device dispatches
    (output order and content are unchanged — see CoalescingAligner).
    ``progress(done, total)`` is called after every region (the
    reference's in-place progress bar, align_main.cc:308-309)."""
    import threading
    done_n = [0]
    plock = threading.Lock()

    def one(line: str) -> list[str]:
        rows = _one_inner(line)
        if progress is not None:
            with plock:
                done_n[0] += 1
                progress(done_n[0], len(bucket_lines))
        return rows

    def _one_inner(line: str) -> list[str]:
        if not line.strip():
            return []
        out: list[str] = []
        h, _ = Hit.from_bed(line)
        h.query_end = min(h.query_end, fr.length(h.query.name))
        h.ref_end = min(h.ref_end, fr.length(h.ref.name))
        h.query.length = fr.length(h.query.name)
        h.ref.length = fr.length(h.ref.name)
        fa = fr.get_sequence(h.query.name, h.query_start, h.query_end)
        fb = fr.get_sequence(h.ref.name, h.ref_start, h.ref_end)
        if h.ref.is_rc:
            fb = revcomp(fb)
        alns = fast_align(fa, fb, h, kmer_size, cfg, al)
        for hh in alns:
            hh.query_start += h.query_start
            hh.query_end += h.query_start
            if h.ref.is_rc:
                hh.ref_start, hh.ref_end = hh.ref_end, hh.ref_start
                hh.ref_start = h.ref_end - hh.ref_start
                hh.ref_end = h.ref_end - hh.ref_end
                hh.ref.is_rc = True
            else:
                hh.ref_start += h.ref_start
                hh.ref_end += h.ref_start
            hh.query.name = h.query.name
            hh.ref.name = h.ref.name
            out.append(hh.to_bed(False) + "\t" + h.to_bed(False))
        return out

    al = aligner
    if jobs <= 1 or len(bucket_lines) <= 1:
        out: list[str] = []
        for line in bucket_lines:
            out.extend(one(line))
        return out
    from concurrent.futures import ThreadPoolExecutor
    from ..ops.cigar import default_aligner
    from ..ops.wavefront import CoalescingAligner
    if al is None:
        al = default_aligner()
    if not isinstance(al, CoalescingAligner):
        al = CoalescingAligner(al)
    with ThreadPoolExecutor(max_workers=jobs) as ex:
        results = list(ex.map(one, bucket_lines))
    return [row for rows in results for row in rows]


class OverlappedTail:
    """Cross-stage overlap driver (beats sedef.sh's strictly sequential
    stage structure): while stage-1 pair jobs stream in, completed merge
    bins flow straight through extend->merge->align->stats on a
    background pool, so the chip's align dispatches run DURING stage 1
    and the host's stats tallies run during the align round trips.

    Correctness: a merge bin (a, b) receives hits only from the two
    strand jobs of the unordered super-bin pair {a, b} (canonical_swap
    can flip a hit to (b, a), never to a third bin), so the bin is
    mergeable the moment both strands of its pair are consumed — and
    both ``aligned.bed`` and ``final.bed`` are canonical_sort_uniq'd
    sets, so processing order cannot change the bytes.  Region rows
    round-trip through to_bed(False)/from_bed exactly like bucket_stage
    (tmp-spill parity).  Byte-identity vs the sequential driver is
    pinned by tests/test_overlap.py.

    The complexity-stratified bucketing this bypasses exists only to
    balance the reference's align PROCESSES (align_main.cc:38-198);
    here the pool + coalescing aligner provide the balance, and the
    bucket machinery remains for the CLI subcommand and the distributed
    driver."""

    def __init__(self, fr, bins, cfg, aligner, align_jobs: int = 8):
        from concurrent.futures import ThreadPoolExecutor

        from ..ops.cigar import default_aligner
        from ..ops.wavefront import CoalescingAligner
        self.fr = fr
        self.cfg = cfg
        self.lookup = {name: bi for bi, names in enumerate(bins)
                       for name in names}
        al = aligner if aligner is not None else default_aligner()
        if not isinstance(al, CoalescingAligner):
            al = CoalescingAligner(al)
        self.al = al
        self.ex = ThreadPoolExecutor(max_workers=align_jobs)
        self.rows_of: dict[tuple[int, int], list[str]] = defaultdict(list)
        self.futs: list = []
        self.n_regions = 0

    def add_job(self, i: int, j: int, is_rc: bool,
                job_lines: list[str]) -> None:
        """Feed one stage-1 job's seed lines (called in job order; the
        rc=True call completes the {i, j} pair and flushes its bins)."""
        for line in job_lines:
            if not line.strip():
                continue
            h, _ = Hit.from_bed(line)
            h.extend(self.cfg.extend.ratio, self.cfg.extend.max_extend)
            canonical_swap(h)
            key = (self.lookup[h.query.name], self.lookup[h.ref.name])
            self.rows_of[key].append(h.to_bed(False))
        if is_rc:
            for key in ((i, j), (j, i)) if i != j else ((i, j),):
                rows = self.rows_of.pop(key, None)
                if rows:
                    self._submit_bin(rows)

    def _submit_bin(self, rows: list[str]) -> None:
        hits = [Hit.from_bed(r)[0] for r in rows]
        hits = merge_hits(hits, self.cfg.extend.merge_dist)
        regions = []
        for h in hits:
            if h.query.is_rc:
                h.query, h.ref = h.ref, h.query
                h.query_start, h.ref_start = h.ref_start, h.query_start
                h.query_end, h.ref_end = h.ref_end, h.query_end
            regions.append(h.to_bed(False))
        self.n_regions += len(regions)
        for line in regions:
            self.futs.append(self.ex.submit(self._region_task, line))

    def _region_task(self, line: str) -> tuple[list[str], list[str]]:
        aligned = align_stage([line], self.fr, self.cfg, self.al)
        final = reporter.stats_rows(aligned, self.fr, self.cfg)
        return aligned, final

    def finish(self) -> tuple[list[str], list[str], int]:
        """Drain: flush any unpaired bins (defensive; job order always
        pairs strands), wait for every region, return
        (aligned_rows, final_rows, n_regions) — both unsorted."""
        for key in list(self.rows_of):
            rows = self.rows_of.pop(key)
            if rows:
                self._submit_bin(rows)
        aligned_all: list[str] = []
        final_all: list[str] = []
        for f in self.futs:
            a, s = f.result()
            aligned_all.extend(a)
            final_all.extend(s)
        self.ex.shutdown()
        return aligned_all, final_all, self.n_regions

    def abort(self) -> None:
        """Cancel queued region tasks (stage-1 failure path): without
        this the executor would keep aligning the whole backlog after
        the pipeline already raised."""
        for f in self.futs:
            f.cancel()
        self.ex.shutdown(wait=False)


_V_RE = re.compile(r"(\d+)")


class _RevStr(str):
    """Reversed string ordering for sort -k...r keys."""

    def __lt__(self, other):  # type: ignore[override]
        return str.__gt__(self, other)

    def __gt__(self, other):  # type: ignore[override]
        return str.__lt__(self, other)


def _version_key(s: str):
    """GNU sort -V-ish key for chromosome names."""
    return tuple(int(p) if p.isdigit() else p for p in _V_RE.split(s))


def canonical_sort_uniq(lines: list[str]) -> list[str]:
    """sort -k1,1V -k9,9r -k10,10r -k4,4V -k2,2n -k3,3n -k5,5n -k6,6n | uniq
    (sedef.sh:221,228)."""
    def key(line: str):
        f = line.split("\t")
        return (_version_key(f[0]), _RevStr(f[8]), _RevStr(f[9]),
                _version_key(f[3]), int(f[1]), int(f[2]), int(f[4]),
                int(f[5]), line)

    out: list[str] = []
    last = None
    for line in sorted(lines, key=key):
        if line != last:
            out.append(line)
        last = line
    return out


def _eprn(msg: str, quiet: bool) -> None:
    if not quiet:
        print(msg, file=sys.stderr, flush=True)


def run_pipeline(fasta_path: str, out_dir: str, cfg: Config = DEFAULT,
                 nbuckets: int = 1000, use_device: bool | None = None,
                 aligner: WavefrontAligner | None = None,
                 jobs: int = 1, quiet: bool = True,
                 force: bool = False,
                 wgac: str | None = None,
                 walls: dict[str, float] | None = None) -> dict[str, str]:
    """Full pipeline on one host; returns paths of the stage outputs.

    ``quiet=False`` reports per-stage wall times and the seed-funnel
    counters on stderr (the reference's section timers + fail report,
    common.h:49-54 / search_main.cc:186-193).  Completed stages are
    resumed from their ``.ok`` sentinel files like the reference driver
    (sedef.sh:129-240) unless ``force``.  ``wgac`` (a WGAC tab file)
    additionally runs the per-SD overlap accounting and the per-base
    coverage diff after final.bed, like ``sedef.sh -w``
    (sedef.sh:246-257), writing ``wgac.report``.  ``walls``, when given,
    receives each stage's wall time in seconds."""
    walls = {} if walls is None else walls
    os.makedirs(out_dir, exist_ok=True)
    # hardware-adaptive dispatch policy: derive the device/host
    # breakevens from this process's measured dispatch latency (the
    # reference's -march=native analog, main.cc:112-123)
    from .. import devcal
    devcal.apply()
    fr = FastaReference(fasta_path)
    bins = generate_translation(fr)

    from ..parallel.distributed import (guard_nonempty, manifest_of,
                                        ok_valid, wipe_stage, write_ok)

    def _ok(stage: str) -> str:
        return os.path.join(out_dir, f"{stage}.ok")

    def _done(stage: str, path: str) -> bool:
        """Sentinel + content-manifest validation: a stage is resumed
        only when the artifact still matches the size/rows/CRC its
        sentinel certified (sentinel-without-content is the poisoned-
        resume hole of VERDICT r4); otherwise the stage is wiped and
        rerun."""
        if force or not ok_valid(_ok(stage), path):
            wipe_stage(out_dir, stage, [path])
            return False
        return True

    from ..ops import filter as filt
    seeds_path = os.path.join(out_dir, "seeds.bed")
    aligned_path = os.path.join(out_dir, "aligned.bed")
    final_path = os.path.join(out_dir, "final.bed")

    # cross-stage overlap (default on for fresh runs): align + stats
    # consume completed merge bins WHILE stage 1 streams pair jobs —
    # the chip no longer idles through stage 1.  SEDEF_NO_OVERLAP=1
    # restores the reference's strictly sequential stage structure
    # (sedef.sh:163-240); resumes always take the sequential path.
    seeds_done = _done("seeds", seeds_path)
    tail: OverlappedTail | None = None
    # align-pool sizing: oversubscription (8+) pays only when region
    # threads block on device round trips; on a host-only aligner it
    # thrashes the GIL
    from ..device import accelerator
    device_align = (getattr(aligner, "use_device", False)
                    if aligner is not None else accelerator() is not None)
    align_jobs = max(jobs, 8 if device_align else (os.cpu_count() or 2))
    if (not seeds_done and not os.environ.get("SEDEF_NO_OVERLAP", "")
            and not _done("aligned", aligned_path)):
        tail = OverlappedTail(fr, bins, cfg, aligner,
                              align_jobs=align_jobs)

    if seeds_done:
        with open(seeds_path) as f:
            n_seeds = sum(1 for line in f if line.strip())
        _eprn(f"[search] resumed  {n_seeds} seeds", quiet)
    else:
        t0 = time.time()
        # per-job completion audit + TIMING rows (sedef.sh:137-158: the
        # reference wraps jobs in /usr/bin/time, greps its GNU-parallel
        # logs, aborts unless every job reported, and aggregates the
        # single-core time / peak RSS)
        job_rows: list[str] = []
        job_secs: list[float] = []
        expected = len(bins) * (len(bins) + 1)

        def _audit(i, j, is_rc, n, dt):
            job_rows.append(
                f"{i}\t{j}\t{int(is_rc)}\t{n}\tTIMING: {dt:.2f}\tOK")
            job_secs.append(dt)
            if not quiet:  # in-place progress (search_main.cc:52-57)
                print(f"\r[search] {len(job_rows)}/{expected} pair jobs",
                      end="", file=sys.stderr, flush=True)

        # stream each job's seeds straight to disk (the reference's
        # per-job seeds/*.bed redirects, sedef.sh:137): stage-1 output
        # memory is bounded by a 2*jobs window of pair jobs (the bounded
        # submission window in search_stage), not the genome's seed set
        todo_order = [(i, j, is_rc)
                      for j in range(len(bins))
                      for i in range(j, len(bins))
                      for is_rc in (False, True)]
        job_idx = [0]
        with open(seeds_path, "w") as seeds_f:

            def _sink(job):
                seeds_f.writelines(ln + "\n" for ln in job)
                if tail is not None:
                    i, j, is_rc = todo_order[job_idx[0]]
                    tail.add_job(i, j, is_rc, job)
                job_idx[0] += 1

            try:
                n_seeds = search_stage(
                    fr, bins, cfg, use_device=use_device, jobs=jobs,
                    progress=_audit, sink=_sink)
            except BaseException:
                if tail is not None:
                    tail.abort()
                raise
        if not quiet:
            print("", file=sys.stderr)
        with open(os.path.join(out_dir, "seeds.joblog"), "w") as f:
            f.write("\n".join(job_rows) + ("\n" if job_rows else ""))
        if len(job_rows) != expected:
            raise RuntimeError(
                f"search stage incomplete: {len(job_rows)}/{expected} "
                "pair jobs reported (see seeds.joblog)")
        try:
            import resource
            rss_mb = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                      // 1024)
        except Exception:  # pragma: no cover
            rss_mb = -1
        audited = sum(int(r.split("\t")[3]) for r in job_rows)
        if n_seeds != audited:
            raise RuntimeError(
                f"seeds.bed holds {n_seeds} rows but the job audits "
                f"reported {audited} — refusing to certify")
        _eprn(f"[search] single-core job time: {sum(job_secs):.1f}s over "
              f"{len(job_secs)} jobs; peak RSS: {rss_mb} MB", quiet)
        walls["search"] = time.time() - t0
        _eprn(f"[search] {walls['search']:8.1f}s  {n_seeds} seeds  "
              f"(attempts={filt.COUNTERS['total']} "
              f"jaccard-fail={filt.COUNTERS['jaccard']} "
              f"interval-fail={filt.COUNTERS['interval']} "
              f"lowercase-fail={filt.COUNTERS['lowercase']} "
              f"qgram-fail={filt.COUNTERS['qgram']})", quiet)
        write_ok(_ok("seeds"), seeds_path)

    if tail is not None:
        # drain the overlapped align+stats tail: most regions already
        # completed during stage 1; write both artifacts with their
        # sentinels exactly as the sequential path would
        t0 = time.time()
        aligned_rows, final_rows, n_regions = tail.finish()
        walls["align+stats drain"] = time.time() - t0
        aligned = canonical_sort_uniq(aligned_rows)
        guard_nonempty("align", len(aligned),
                       manifest_of(seeds_path)["rows"])
        _eprn(f"[align]  {time.time() - t0:8.1f}s drain  "
              f"{n_regions} regions  {len(aligned)} alignments "
              f"(overlapped)", quiet)
        with open(aligned_path, "w") as f:
            f.write("\n".join(aligned) + ("\n" if aligned else ""))
        write_ok(_ok("aligned"), aligned_path)
        final_rows = canonical_sort_uniq(final_rows)
        guard_nonempty("stats", len(final_rows), len(aligned))
        with open(final_path, "w") as f:
            f.write(reporter.HEADER + "\n")
            f.write("\n".join(final_rows)
                    + ("\n" if final_rows else ""))
        write_ok(_ok("final"), final_path)
        _eprn(f"[stats]  {len(final_rows)} final SDs (overlapped)",
              quiet)
        paths = {"seeds": seeds_path, "aligned": aligned_path,
                 "final": final_path}
        return _wgac_report(paths, fr, out_dir, wgac, quiet)

    if _done("aligned", aligned_path):
        aligned = open(aligned_path).read().splitlines()
        guard_nonempty("align (resumed)", len(aligned),
                       manifest_of(seeds_path)["rows"])
        _eprn(f"[align]  resumed  {len(aligned)} alignments", quiet)
    else:
        t0 = time.time()
        with open(seeds_path) as seeds_f:
            buckets = bucket_stage(seeds_f, fr, bins, nbuckets, cfg,
                                   tmp_dir=os.path.join(out_dir,
                                                        "align_tmp"))
        walls["bucket"] = time.time() - t0
        _eprn(f"[bucket] {walls['bucket']:8.1f}s  "
              f"{sum(len(b) for b in buckets)} regions", quiet)

        t0 = time.time()
        # one flat region list: per-region threads + the coalescing
        # aligner batch gap DPs across ALL regions per device dispatch
        flat = [line for bucket in buckets for line in bucket]

        def _aprog(done, total):
            if not quiet and (done % 256 == 0 or done == total):
                print(f"\r[align] {done}/{total} regions", end="",
                      file=sys.stderr, flush=True)

        aligned = align_stage(flat, fr, cfg, aligner,
                              jobs=align_jobs if len(flat) > 1 else 1,
                              progress=_aprog)
        if not quiet and flat:
            print("", file=sys.stderr)
        aligned = canonical_sort_uniq(aligned)
        guard_nonempty("align", len(aligned),
                       manifest_of(seeds_path)["rows"])
        walls["align"] = time.time() - t0
        _eprn(f"[align]  {walls['align']:8.1f}s  "
              f"{len(aligned)} alignments", quiet)
        with open(aligned_path, "w") as f:
            f.write("\n".join(aligned) + ("\n" if aligned else ""))
        write_ok(_ok("aligned"), aligned_path)

    if _done("final", final_path):
        guard_nonempty("stats (resumed)",
                       max(manifest_of(final_path)["rows"] - 1, 0),
                       len(aligned))
        _eprn("[stats]  resumed", quiet)
    else:
        t0 = time.time()
        final_rows = reporter.stats_rows(aligned, fr, cfg, jobs=jobs)
        final_rows = canonical_sort_uniq(final_rows)
        guard_nonempty("stats", len(final_rows), len(aligned))
        walls["stats"] = time.time() - t0
        _eprn(f"[stats]  {walls['stats']:8.1f}s  "
              f"{len(final_rows)} final SDs", quiet)
        with open(final_path, "w") as f:
            f.write(reporter.HEADER + "\n")
            f.write("\n".join(final_rows) + ("\n" if final_rows else ""))
        write_ok(_ok("final"), final_path)
    paths = {"seeds": seeds_path, "aligned": aligned_path,
             "final": final_path}
    return _wgac_report(paths, fr, out_dir, wgac, quiet)


def _wgac_report(paths: dict, fr: FastaReference, out_dir: str,
                 wgac: str | None, quiet: bool) -> dict:
    """Optional post-final WGAC accounting (sedef.sh -w,
    sedef.sh:246-257): per-SD overlap classes + per-base coverage
    diff written to wgac.report."""
    if wgac:
        from .evaluate import check_overlap, diff
        t0 = time.time()
        final_lines = open(paths["final"]).read().splitlines()
        wgac_lines = open(wgac).read().splitlines()
        ov = check_overlap(final_lines, wgac_lines)
        dv = diff(fr, final_lines, wgac_lines)
        report_path = os.path.join(out_dir, "wgac.report")
        with open(report_path, "w") as f:
            f.write(ov.report() + "\n" + dv.report() + "\n")
        _eprn(f"[wgac]   {time.time() - t0:8.1f}s  report in "
              f"{report_path}", quiet)
        paths["wgac"] = report_path
    return paths
