"""End-to-end reference diff: run the REAL reference pipeline (compiled
from /root/reference sources with the fakeboost stubs, tools/oracles) and
our pipeline on the same simulated genome, then compare seeds.bed /
aligned.bed / final.bed.

Usage: python tools/ref_diff.py [length] [n_sds] [--seed N] [--repeats]
       [--nbuckets N] [--keep]

This is the offline stand-in for BASELINE configs 2-4 (real-genome
parity): multi-chromosome, soft-masked background, N-runs, forward +
reverse-complement SDs, optional repeat families.
"""

import os
import pathlib
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

REF = "/root/reference"
ORACLES = pathlib.Path(__file__).resolve().parent / "oracles"
REFBIN = "/tmp/refsedef"

SORT_KEYS = ["-k1,1V", "-k9,9r", "-k10,10r", "-k4,4V", "-k2,2n", "-k3,3n",
             "-k5,5n", "-k6,6n"]


def build_refbin():
    if os.path.exists(REFBIN):
        return
    srcs = ["main.cc", "search_main.cc", "align_main.cc", "stats_main.cc",
            "search.cc", "sliding.cc", "filter.cc", "hash.cc", "hit.cc",
            "align.cc", "chain.cc", "refine.cc", "merge.cc", "fasta.cc",
            "globals.cc"]
    cmd = (["g++", "-std=c++14", "-O2", "-msse4.1", "-fopenmp",
            "-include", "algorithm", "-DGITVER=\"refdiff\"",
            f"-I{REF}/src", f"-I{REF}", f"-I{ORACLES}/fakeboost"]
           + [f"{REF}/src/{s}" for s in srcs]
           + [str(ORACLES / "util_stub.cc"), f"{REF}/extern/format.cc",
              f"{REF}/extern/ksw2_extz2_sse.cc", "-o", REFBIN])
    print("building reference binary...", flush=True)
    subprocess.run(cmd, check=True)


def run_reference(fa: str, out: str, nbuckets: int, jobs: int = 2):
    os.makedirs(f"{out}/seeds", exist_ok=True)
    os.makedirs(f"{out}/align", exist_ok=True)
    numchrs = int(subprocess.run(
        [REFBIN, "translate", fa], capture_output=True, text=True,
        check=True).stdout.strip().split()[-1])
    print(f"reference: {numchrs} super-bins", flush=True)
    jobs_list = []
    for j in range(numchrs):
        for i in range(j, numchrs):
            for m, rcf in (("n", []), ("y", ["-r"])):
                jobs_list.append((f"{out}/seeds/{i}_{j}_{m}.bed",
                                  [REFBIN, "search", "-k", "12", "-w", "16",
                                   *rcf, fa, "-t", str(i), str(j)]))
    t0 = time.time()
    procs = []
    for path, cmd in jobs_list:
        while len([p for p in procs if p[0].poll() is None]) >= jobs:
            time.sleep(0.2)
        f = open(path, "w")
        procs.append((subprocess.Popen(cmd, stdout=f,
                                       stderr=subprocess.DEVNULL), f))
    for p, f in procs:
        rc = p.wait()
        f.close()
        assert rc == 0, f"reference search job failed rc={rc}"
    print(f"reference search: {time.time()-t0:.1f}s "
          f"({len(jobs_list)} jobs)", flush=True)

    t0 = time.time()
    subprocess.run([REFBIN, "align", "bucket", "-n", str(nbuckets),
                    f"{out}/seeds", f"{out}/align", fa],
                   check=True, stderr=subprocess.DEVNULL)
    print(f"reference bucket: {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    buckets = sorted(pathlib.Path(f"{out}/align").glob("bucket_????"))
    procs = []
    for b in buckets:
        while len([p for p in procs if p[0].poll() is None]) >= jobs:
            time.sleep(0.2)
        f = open(f"{b}.aligned.bed", "w")
        procs.append((subprocess.Popen(
            [REFBIN, "align", "generate", "-k", "11", fa, str(b)],
            stdout=f, stderr=subprocess.DEVNULL), f))
    for p, f in procs:
        rc = p.wait()
        f.close()
        assert rc == 0, "reference align job failed"
    print(f"reference align: {time.time()-t0:.1f}s "
          f"({len(buckets)} buckets)", flush=True)

    with open(f"{out}/seeds.bed", "w") as fo:
        for p in sorted(pathlib.Path(f"{out}/seeds").glob("*.bed")):
            fo.write(open(p).read())
    cat = subprocess.run(
        f"cat {out}/align/*.aligned.bed | LC_ALL=C sort "
        + " ".join(SORT_KEYS) + f" | uniq > {out}/aligned.bed",
        shell=True)
    assert cat.returncode == 0

    t0 = time.time()
    env = dict(os.environ, OMP_NUM_THREADS=str(jobs))
    stats = subprocess.run(
        f"{REFBIN} stats generate {fa} {out}/aligned.bed 2>/dev/null "
        f"| LC_ALL=C sort " + " ".join(SORT_KEYS)
        + f" | uniq > {out}/final.bed", shell=True, env=env)
    assert stats.returncode == 0
    print(f"reference stats: {time.time()-t0:.1f}s", flush=True)


def rows_of(path: str) -> list[str]:
    return sorted(ln for ln in open(path).read().splitlines()
                  if ln.strip() and not ln.startswith("#"))


def main():
    # correctness harness: force the CPU backend unless --device is
    # passed
    if "--device" not in sys.argv:
        import jax
        jax.config.update("jax_platforms", "cpu")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    length = int(args[0]) if args else 50_000_000
    n_sds = int(args[1]) if len(args) > 1 else 40
    seed = 11
    nbuckets = 64
    fams, copies, jobs = 20, 30, 2
    n_chroms = None
    for a in sys.argv[1:]:
        if a.startswith("--seed="):
            seed = int(a.split("=")[1])
        if a.startswith("--nbuckets="):
            nbuckets = int(a.split("=")[1])
        if a.startswith("--fams="):
            fams = int(a.split("=")[1])
        if a.startswith("--copies="):
            copies = int(a.split("=")[1])
        if a.startswith("--chroms="):
            n_chroms = int(a.split("=")[1])
        if a.startswith("--jobs="):
            jobs = int(a.split("=")[1])
    repeats = "--repeats" in sys.argv

    from sedef_tpu.io.fasta import write_fai
    from sedef_tpu.models.genome_sim import simulate_genome, write_fasta
    from sedef_tpu.models.pipeline import run_pipeline

    kw = dict(repeat_families=fams, repeat_copies=copies) if repeats else {}
    if n_chroms is None:
        n_chroms = max(2, length // 12_000_000)
    chroms, planted = simulate_genome(
        length, n_sds, n_chroms=n_chroms, seed=seed,
        n_run_every=997_000, **kw)
    work = tempfile.mkdtemp(prefix="refdiff_")
    fa = f"{work}/genome.fa"
    write_fasta(fa, chroms)
    write_fai(fa)  # the reference binary requires ${input}.fai (sedef.sh
    # runs samtools faidx; our writer is byte-compatible)
    print(f"genome: {length/1e6:.0f} Mbp, {len(chroms)} chroms, "
          f"{len(planted)} SDs, work={work}", flush=True)

    build_refbin()
    run_reference(fa, f"{work}/ref", nbuckets, jobs=jobs)

    t0 = time.time()
    ours = run_pipeline(fa, f"{work}/ours", nbuckets=nbuckets, jobs=jobs,
                        quiet=False)
    print(f"ours total: {time.time()-t0:.1f}s", flush=True)

    ok = True
    for name, rp, op in (("seeds", f"{work}/ref/seeds.bed", ours["seeds"]),
                         ("aligned", f"{work}/ref/aligned.bed",
                          ours["aligned"]),
                         ("final", f"{work}/ref/final.bed", ours["final"])):
        r = rows_of(rp)
        o = rows_of(op)
        if r == o:
            print(f"{name}: IDENTICAL ({len(r)} rows)")
        else:
            ok = False
            rs, os_ = set(r), set(o)
            print(f"{name}: DIFF ref={len(r)} ours={len(o)} "
                  f"ref-only={len(rs-os_)} ours-only={len(os_-rs)}")
            for ln in sorted(rs - os_)[:3]:
                print("  REF :", ln[:160])
            for ln in sorted(os_ - rs)[:3]:
                print("  OURS:", ln[:160])
    if "--keep" not in sys.argv and ok:
        import shutil
        shutil.rmtree(work)
    print("RESULT:", "IDENTICAL" if ok else f"DIVERGED (work dir: {work})")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
