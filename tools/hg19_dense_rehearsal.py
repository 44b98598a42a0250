"""hg19-DENSITY dress rehearsal (VERDICT r4 item 2).

The r4 rehearsal validated 3 Gbp scale at ~70x fewer seeds per Gbp than
real hg19 (~0.011 vs ~0.75 seeds/Kbp); this driver re-runs it at
hg19-realistic seed density (target >= 0.7 seeds/Kbp, calibrated:
repeat_families=150 + copies=90 per 50 Mbp gives 0.70) so the align and
stats stages see hg19-scale work per Gbp.  Records per-stage walls and
seed density into docs/HG19_DENSE.json, with the device they ran on.

Usage:
  python tools/hg19_dense_rehearsal.py [--gbp=3.0] [--jobs=2]
      [--fresh] [--stage1-only]
"""

import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

os.environ.setdefault("SEDEF_INDEX_CACHE_GB", "64")

WORK = "/tmp/hg19dense"
DOCS = pathlib.Path(__file__).resolve().parent.parent / "docs"

# density calibration (measured on 50/100 Mbp pilots, r5):
#   fams=150, copies=90 per 50 Mbp, sds=1/120Kbp -> 0.700 seeds/Kbp
FAMS_PER_50M = 150
COPIES = 90


def generate(gbp: float, force: bool) -> str:
    from sedef_tpu.io.fasta import write_fai
    from sedef_tpu.models.genome_sim import simulate_genome, write_fasta

    os.makedirs(WORK, exist_ok=True)
    fa = f"{WORK}/genome.fa"
    if not force and os.path.exists(fa) and os.path.exists(fa + ".fai"):
        print(f"genome cached: {fa}", flush=True)
        return fa
    length = int(gbp * 1e9)
    n_chroms = max(2, round(length / 125_000_000))
    fams = round(FAMS_PER_50M * length / 50_000_000)
    t0 = time.time()
    chroms, planted = simulate_genome(
        length, length // 120_000, sd_min=1300, sd_max=20_000,
        max_divergence=0.12, rc_fraction=0.3, n_chroms=n_chroms,
        seed=1905, n_run_every=997_000,
        repeat_families=fams, repeat_copies=COPIES,
        repeat_len=(500, 2500), repeat_div=(0.08, 0.40))
    print(f"simulated {length/1e9:.2f} Gbp / {n_chroms} chroms / "
          f"{fams} fams x {COPIES}: {time.time()-t0:.0f}s", flush=True)
    t0 = time.time()
    write_fasta(fa, chroms)
    write_fai(fa)
    print(f"wrote {fa} in {time.time()-t0:.0f}s", flush=True)
    return fa


def main():
    gbp = 3.0
    jobs = 2
    for a in sys.argv[1:]:
        if a.startswith("--gbp="):
            gbp = float(a.split("=")[1])
        if a.startswith("--jobs="):
            jobs = int(a.split("=")[1])
    fa = generate(gbp, "--fresh" in sys.argv)

    import io

    import jax

    from sedef_tpu.models.pipeline import run_pipeline

    log = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            log.write(s)
            sys.__stderr__.write(s)
            return len(s)

        def flush(self):
            sys.__stderr__.flush()

    from contextlib import redirect_stderr
    t0 = time.time()
    with redirect_stderr(Tee()):
        paths = run_pipeline(fa, f"{WORK}/ours", jobs=jobs, quiet=False)
    wall = time.time() - t0

    counts = {}
    for name, p in paths.items():
        with open(p) as f:
            counts[name] = sum(1 for line in f
                               if line.strip() and not line.startswith("#"))
    stage_s = {}
    for ln in log.getvalue().splitlines():
        for stage in ("search", "bucket", "align", "stats"):
            tag = f"[{stage}]"
            if ln.strip().startswith(tag) and "s " in ln:
                try:
                    stage_s[stage] = float(
                        ln.split(tag)[1].split("s")[0])
                except ValueError:
                    pass
    report = {
        "spec": f"sim({gbp:.1f}Gbp,dense:fams{round(FAMS_PER_50M*gbp*20)}"
                f"x{COPIES},seed1905)",
        "jobs": jobs,
        "wall_s": round(wall, 1),
        "stage_s": stage_s,
        "rows": counts,
        "seeds_per_kbp": round(counts.get("seeds", 0)
                               / (gbp * 1e6), 3),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }
    DOCS.mkdir(exist_ok=True)
    out = DOCS / (f"HG19_DENSE.json" if abs(gbp - 3.0) < 0.01
                  else f"HG19_DENSE_{gbp:g}gbp.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1), flush=True)


if __name__ == "__main__":
    main()
