"""hg19 dress rehearsal at full genome scale.

Generates a 3 Gbp / 24-chromosome genome at hg19-like SD density
(preprint §4.1: ~2.25 M seed regions -> ~68 K final SD pairs over
~219 Mbp), runs the full pipeline end-to-end, byte-diffs a SAMPLED
super-bin pair of stage 1 against the compiled reference binary on the
same genome, and records per-stage wall times into
docs/HG19_REHEARSAL.json.

Usage:
  python tools/hg19_rehearsal.py [--gbp=3.0] [--chroms=24] [--jobs=2]
      [--sample-only] [--fresh]

The genome and pipeline outputs are cached under /tmp/hg19ish (resume
via the driver's .ok sentinels); --fresh regenerates everything.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

os.environ.setdefault("SEDEF_INDEX_CACHE_GB", "64")

WORK = "/tmp/hg19ish"
DOCS = pathlib.Path(__file__).resolve().parent.parent / "docs"


def generate(gbp: float, n_chroms: int, force: bool) -> str:
    from sedef_tpu.io.fasta import write_fai
    from sedef_tpu.models.genome_sim import simulate_genome, write_fasta

    os.makedirs(WORK, exist_ok=True)
    fa = f"{WORK}/genome.fa"
    meta = f"{WORK}/genome.json"
    if not force and os.path.exists(fa) and os.path.exists(meta):
        print(f"genome cached: {fa}", flush=True)
        return fa
    length = int(gbp * 1e9)
    t0 = time.time()
    # density targets (preprint §4.1): planted true SDs ~25 K pairs of
    # 1.3-20 Kbp at <=12% divergence plus ~500 repeat families x 25
    # copies as seed-stage distractors; together they land in the
    # ~50-70 K final-SD ballpark of hg19
    chroms, planted = simulate_genome(
        length, 25_000, sd_min=1300, sd_max=20_000,
        max_divergence=0.12, rc_fraction=0.3, n_chroms=n_chroms,
        seed=1905, n_run_every=997_000,
        repeat_families=500, repeat_copies=25,
        repeat_len=(500, 2500), repeat_div=(0.08, 0.40))
    print(f"simulated {length/1e9:.1f} Gbp / {n_chroms} chroms, "
          f"{len(planted)} planted SDs in {time.time()-t0:.0f}s",
          flush=True)
    t0 = time.time()
    write_fasta(fa, chroms)
    write_fai(fa)
    with open(meta, "w") as f:
        json.dump({"length": length, "n_chroms": n_chroms,
                   "planted": len(planted)}, f)
    print(f"wrote {fa} in {time.time()-t0:.0f}s", flush=True)
    return fa


def run_ours(fa: str, jobs: int) -> dict:
    import io
    from contextlib import redirect_stderr

    from sedef_tpu.models.pipeline import run_pipeline

    out_dir = f"{WORK}/ours"
    log = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            log.write(s)
            sys.__stderr__.write(s)
            return len(s)

        def flush(self):
            sys.__stderr__.flush()

    t0 = time.time()
    with redirect_stderr(Tee()):
        paths = run_pipeline(fa, out_dir, jobs=jobs, quiet=False)
    wall = time.time() - t0
    stage_s = {}
    for ln in log.getvalue().splitlines():
        for stage in ("search", "bucket", "align", "stats"):
            tag = f"[{stage}]"
            if ln.strip().startswith(tag) and "s " in ln:
                try:
                    stage_s[stage] = float(ln.split(tag)[1].split("s")[0])
                except ValueError:
                    pass
    counts = {}
    for name, p in paths.items():
        with open(p) as f:
            counts[name] = sum(1 for line in f
                               if line.strip() and not line.startswith("#"))
    return {"wall_s": round(wall, 1), "stage_s": stage_s,
            "rows": counts, "paths": paths}


def sampled_ref_diff(fa: str, jobs: int) -> dict:
    """Byte-diff stage 1 for sampled super-bin pairs: the reference
    binary's `search -t i j` output vs our search_job on the same bins.
    Samples the two SMALLEST bins (fast on a 3 Gbp genome) plus one
    self-pair, both strands."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from ref_diff import REFBIN, build_refbin

    from sedef_tpu.config import DEFAULT
    from sedef_tpu.io.fasta import FastaReference, generate_translation
    from sedef_tpu.models import pipeline as pl

    build_refbin()
    fr = FastaReference(fa)
    bins = generate_translation(fr)
    numchrs = int(subprocess.run(
        [REFBIN, "translate", fa], capture_output=True, text=True,
        check=True).stdout.strip().split()[-1])
    assert numchrs == len(bins), (numchrs, len(bins))
    # bins are sorted by length desc -> the last two are the smallest
    a = len(bins) - 1
    b = max(0, len(bins) - 2)
    samples = [(a, a, False), (a, a, True)]
    if b != a:
        samples = [(a, b, False), (a, b, True)] + samples
    cache = pl.IndexCache(fr, DEFAULT, use_device=False)
    out = {}
    for (i, j, rc) in samples:
        t0 = time.time()
        ref_rows = subprocess.run(
            [REFBIN, "search", "-k", "12", "-w", "16"]
            + (["-r"] if rc else []) + [fa, "-t", str(i), str(j)],
            capture_output=True, text=True, check=True).stdout
        t_ref = time.time() - t0
        t0 = time.time()
        ours = pl.search_job(fr, bins[i], bins[j], rc, DEFAULT,
                             use_device=False, cache=cache)
        t_ours = time.time() - t0
        r = sorted(ln for ln in ref_rows.splitlines() if ln.strip())
        o = sorted(ln for ln in ours if ln.strip())
        key = f"bins_{i}_{j}_{'rc' if rc else 'fwd'}"
        out[key] = {"identical": r == o, "rows": len(o),
                    "ref_s": round(t_ref, 1), "ours_s": round(t_ours, 1)}
        print(f"sample {key}: identical={r == o} rows={len(o)} "
              f"ref={t_ref:.1f}s ours={t_ours:.1f}s", flush=True)
        if r != o:
            rs, os_ = set(r), set(o)
            for ln in sorted(rs - os_)[:2]:
                print("  REF :", ln[:160], flush=True)
            for ln in sorted(os_ - rs)[:2]:
                print("  OURS:", ln[:160], flush=True)
    return out


def main():
    gbp = 3.0
    n_chroms = 24
    jobs = 2
    for a in sys.argv[1:]:
        if a.startswith("--gbp="):
            gbp = float(a.split("=")[1])
        if a.startswith("--chroms="):
            n_chroms = int(a.split("=")[1])
        if a.startswith("--jobs="):
            jobs = int(a.split("=")[1])
    fa = generate(gbp, n_chroms, "--fresh" in sys.argv)

    report = {"spec": f"sim({gbp:.1f}Gbp,{n_chroms}chr,sds25000,"
                      f"fams500x25,seed1905)", "jobs": jobs}
    if "--sample-only" not in sys.argv:
        report["pipeline"] = run_ours(fa, jobs)
    report["sampled_ref_diff"] = sampled_ref_diff(fa, jobs)

    DOCS.mkdir(exist_ok=True)
    with open(DOCS / "HG19_REHEARSAL.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1), flush=True)


if __name__ == "__main__":
    main()
