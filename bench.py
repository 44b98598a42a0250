#!/usr/bin/env python
"""Benchmark on one GPU: gap-DP throughput of both device routes, the
end-to-end pipeline, and the stage-1 prefilter rows.

Prints the card (``platform``, ``device_kind``, device count, and
``nvidia-smi --query-gpu=name,power.limit``) and then ONE JSON line:
{"metric", "value", "unit", "extra"}.  Exits non-zero without a GPU: a
CPU number is never reported under a device metric.

Metric: GCUPS (useful L x L cells per second) of the production gap-DP
route (the CUDA kernel, fill + traceback, packed ops out) at L = 1024;
``extra`` holds the plain-JAX route (``wavefront_cigar_scan``, what XLA
compiles from the same recurrence) at the same shape and both routes per
size class.  Each value is the median of BENCH_REPS timings of N
invocations chained inside one jit with a data dependency and ended by a
host pull of an in-graph checksum.

extra rows:
  e2e_*       — end-to-end pipeline on sim(20 Mbp, 4 chroms, fams=20,
                copies=40, seed=7), jobs = host cores
  prefilter_* — stage-1 host-roll time with the device roll prefilter
                off / production policy / forced, on the roll-bound
                workload sim(4 Mbp, 2 chroms, fams=8, copies=250, seed=11)
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

BENCH_REPS = 3
# problems per call by size class: enough resident blocks for 132 SMs
BATCH = {128: 4096, 256: 4096, 512: 2048, 1024: 1024, 2048: 512,
         4096: 264, 8192: 132}
# the plain route holds the whole (B, 2L-1, L) direction matrix, twice
PLAIN_BYTES = 8 << 30
JOBS = os.cpu_count() or 1
# reference seed stage: ~8.8 s/Mbp-core (hg19 7h33m single core, preprint
# Table 1) => on the e2e workload below (20 Mbp, 4 chroms, 20 pair jobs)
# the reference single-core stage-1 time is ~176 s; pair-jobs/hour follows.
REF_PAIR_JOBS_PER_HOUR = 20 / (20 * 8.8 / 3600.0)


def e2e_metrics() -> dict:
    """End-to-end pipeline wall time + chr-pair-job throughput on a fixed
    20 Mbp 4-chromosome repeat-rich synthetic genome (machine-checked
    across rounds; BASELINE.json metric #2 stand-in)."""
    import tempfile

    from sedef_tpu.config import DEFAULT
    from sedef_tpu.io.fasta import FastaReference, generate_translation
    from sedef_tpu.models import pipeline as pl
    from sedef_tpu.models import reporter
    from sedef_tpu.models.genome_sim import simulate_genome, write_fasta
    from sedef_tpu.ops.wavefront import WavefrontAligner

    from sedef_tpu.native import lib as native

    chroms, planted = simulate_genome(20_000_000, 20, seed=7, n_chroms=4,
                                      repeat_families=20, repeat_copies=40)
    tmp = tempfile.mkdtemp()
    fa = tmp + "/bench.fa"
    write_fasta(fa, chroms)
    fr = FastaReference(fa)
    bins = generate_translation(fr)
    n_jobs = len(bins) * (len(bins) + 1)  # i>=j x 2 strands

    # e2e: the PRODUCTION driver (run_pipeline), overlapped stages —
    # align/stats consume merge bins while stage 1 streams (r5).
    # Pre-warm the dispatch calibration so its probe compile is not
    # charged to the e2e wall (one-time per process, not per genome).
    from sedef_tpu import devcal
    devcal.get()
    t0 = time.perf_counter()
    out = pl.run_pipeline(fa, tmp + "/out", DEFAULT, nbuckets=16,
                          aligner=WavefrontAligner(), jobs=JOBS)
    t_e2e = time.perf_counter() - t0
    final = [ln for ln in open(out["final"]).read().splitlines()
             if not ln.startswith("#")]

    # stage 1 alone (fresh cache): phase counters + pair-job throughput
    native.prof_reset()
    t0 = time.perf_counter()
    seeds = pl.search_stage(fr, bins, DEFAULT, jobs=JOBS)
    t_search = time.perf_counter() - t0
    assert len(seeds) > 0
    prof = native.prof_get()
    phase_s = {k: round(prof[k] / 1e9, 2)
               for k in ("collect", "cluster", "roll", "replay", "extend",
                         "filter")}
    from sedef_tpu.models.genome_sim import recall_of
    rec = recall_of(final, planted)
    pair_jobs_per_hour = n_jobs / (t_search / 3600.0)
    return {
        "e2e_spec": f"sim(20Mbp,4chr,fams20,copies40,seed7),jobs={JOBS}",
        "e2e_20mbp_s": round(t_e2e, 1),
        "stage1_20mbp_s": round(t_search, 1),
        "stage1_phase_s": phase_s,
        "pair_jobs_per_hour": round(pair_jobs_per_hour),
        "pair_jobs_vs_ref_core": round(
            pair_jobs_per_hour / REF_PAIR_JOBS_PER_HOUR, 1),
        "recall": f"{rec}/{len(planted)}",
    }


def prefilter_metrics() -> dict:
    """Stage-1 roll prefilter economics on a roll-bound dense-repeat
    genome.  Three rows:

    * ``off``    — prefilter disabled outright,
    * ``on``     — the production policy (devcal.apply() on this card,
                   or SEDEF_PREFILTER),
    * ``forced`` — the device path forced on (regression-tracks the
                   device bound's cost and its roll-step pruning).
    """
    import tempfile

    from sedef_tpu.config import DEFAULT
    from sedef_tpu.io.fasta import FastaReference, generate_translation
    from sedef_tpu.models import pipeline as pl
    from sedef_tpu.models import seeder
    from sedef_tpu.models.genome_sim import simulate_genome, write_fasta
    from sedef_tpu.native import lib as native

    if not native.has("search_plan"):  # pragma: no cover
        return {}
    chroms, _ = simulate_genome(4_000_000, 5, seed=11, n_chroms=2,
                                repeat_families=8, repeat_copies=250,
                                repeat_len=(600, 1200),
                                repeat_div=(0.10, 0.35))
    tmp = tempfile.mkdtemp()
    fa = tmp + "/dense.fa"
    write_fasta(fa, chroms)
    out = {"prefilter_spec":
           f"sim(4Mbp,2chr,fams8,copies250,seed11),jobs={JOBS}"}
    old = seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS
    try:
        for label, flags in (("off", (False, 0)),
                             ("on", old),        # production policy
                             ("forced", (True, 0))):
            seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS = flags
            fr = FastaReference(fa)
            bins = generate_translation(fr)
            native.prof_reset()
            t0 = time.perf_counter()
            # shard_bp=0 + use_device: the prefilter lives on the
            # whole-job device path (the sharded default never dispatches
            # it, and stage-1 device ops are opt-in)
            seeds = pl.search_stage(fr, bins, DEFAULT, jobs=JOBS,
                                    shard_bp=0, use_device=True)
            dt = time.perf_counter() - t0
            prof = native.prof_get()
            out[f"prefilter_{label}_stage1_s"] = round(dt, 1)
            out[f"prefilter_{label}_roll_s"] = round(prof["roll"] / 1e9, 2)
            out[f"prefilter_{label}_roll_steps"] = int(prof["roll_steps"])
            out[f"prefilter_{label}_seeds"] = len(seeds)
    finally:
        seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS = old
    if out.get("prefilter_off_roll_s", 0) > 0:
        out["prefilter_roll_speedup_forced"] = round(
            out["prefilter_off_roll_s"]
            / max(out["prefilter_forced_roll_s"], 0.01), 1)
    return out


def gcups(L_q: int, L_t: int, B: int, cuda: bool, N: int = 2) -> float:
    """Median GCUPS of N chained fill + traceback calls on B full-length
    (L_q x L_t) problems."""
    import jax
    import jax.numpy as jnp

    from sedef_tpu.ops.wavefront import gap_dp_packed

    rng = np.random.default_rng(0)
    q = jax.device_put(rng.integers(0, 4, (B, L_q)).astype(np.int8))
    t = jax.device_put(rng.integers(0, 4, (B, L_t)).astype(np.int8))
    ql = jnp.full((B,), L_q, jnp.int32)
    tl = jnp.full((B,), L_t, jnp.int32)

    @jax.jit
    def run_chain(q, t, ql, tl):
        def body(i, acc):
            q2 = q.at[:, 0].set((acc % 4).astype(jnp.int8))
            ops = gap_dp_packed(q2, t, ql, tl, L_q, L_t, cuda=cuda)
            return acc + ops.astype(jnp.int32).sum()
        return jax.lax.fori_loop(0, N, body, jnp.int32(0))

    int(run_chain(q, t, ql, tl))  # warmup / compile
    samples = []
    for _ in range(BENCH_REPS):
        t0 = time.perf_counter()
        acc = int(run_chain(q, t, ql, tl))
        dt = time.perf_counter() - t0
        assert acc != 0
        samples.append(float(B) * L_q * L_t * N / dt / 1e9)
    return statistics.median(samples)


def main() -> int:
    import jax

    from sedef_tpu.debug import enable_compilation_cache
    from sedef_tpu.device import accelerator

    dev = accelerator()
    if dev is None:
        print("bench: JAX finds no GPU; nothing to measure", file=sys.stderr)
        return 2
    enable_compilation_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"platform={dev.platform} device_kind={dev.device_kind} "
          f"count={len(jax.devices())} card={card}", flush=True)

    extra = {"platform": dev.platform, "device_kind": dev.device_kind,
             "device_count": len(jax.devices()), "card": card,
             "gcups_reps": BENCH_REPS}
    for L, B in BATCH.items():
        cells = (2 * L - 1) * L
        for route, cuda in (("cuda", True), ("plain", False)):
            b = B if cuda else max(1, min(B, PLAIN_BYTES // (2 * cells)))
            extra[f"gcups_{route}_L{L}"] = round(gcups(L, L, b, cuda), 3)
            extra[f"batch_{route}_L{L}"] = b
            print(f"L={L} {route} B={b}: {extra[f'gcups_{route}_L{L}']} "
                  "GCUPS", flush=True)
    extra.update(e2e_metrics())
    extra.update(prefilter_metrics())
    print(json.dumps({
        "metric": "gap_dp_gcups_L1024",
        "value": extra["gcups_cuda_L1024"],
        "unit": "GCUPS",
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
