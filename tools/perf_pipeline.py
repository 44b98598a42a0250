"""Pipeline scale/perf harness on synthetic SD genomes.

Usage: python tools/perf_pipeline.py [length] [n_sds] [--cpu-align]
Reports per-stage wall time and planted-SD recall.
"""
import sys, time, tempfile, os
import pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import jax

length = int(sys.argv[1]) if len(sys.argv) > 1 else 5_000_000
n_sds = int(sys.argv[2]) if len(sys.argv) > 2 else 20
cpu_align = "--cpu-align" in sys.argv
if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

from sedef_tpu.config import DEFAULT
from sedef_tpu.io.fasta import FastaReference, generate_translation
from sedef_tpu.models.genome_sim import simulate_genome, write_fasta
from sedef_tpu.models import pipeline as pl
from sedef_tpu.models import reporter
from sedef_tpu.ops.wavefront import WavefrontAligner

t0 = time.time()
chroms, planted = simulate_genome(length, n_sds, seed=1)
tmp = tempfile.mkdtemp()
fa = os.path.join(tmp, "sim.fa")
write_fasta(fa, chroms)
print(f"genome: {length/1e6:.1f} Mbp, {len(planted)} planted SDs "
      f"({time.time()-t0:.1f}s)")

fr = FastaReference(fa)
bins = generate_translation(fr)

t0 = time.time()
seeds = pl.search_stage(fr, bins, DEFAULT)
t_search = time.time() - t0
print(f"stage1 search : {t_search:7.1f}s  ({len(seeds)} seeds)")

t0 = time.time()
buckets = pl.bucket_stage(seeds, fr, bins, 16, DEFAULT)
t_bucket = time.time() - t0
nb = sum(len(b) for b in buckets)
print(f"stage2a bucket: {t_bucket:7.1f}s  ({nb} regions)")

al = WavefrontAligner(use_device=False) if cpu_align else WavefrontAligner()
t0 = time.time()
flat = [line for b in buckets for line in b]
aligned = pl.align_stage(flat, fr, DEFAULT, al, jobs=8)
aligned = pl.canonical_sort_uniq(aligned)
t_align = time.time() - t0
print(f"stage2b align : {t_align:7.1f}s  ({len(aligned)} alignments)")

t0 = time.time()
final = reporter.stats_rows(aligned, fr, DEFAULT)
final = pl.canonical_sort_uniq(final)
t_stats = time.time() - t0
print(f"stage3 stats  : {t_stats:7.1f}s  ({len(final)} final SDs)")

# recall vs planted
from sedef_tpu.models.genome_sim import recall_of
found = recall_of(final, planted)
print(f"recall: {found}/{len(planted)}  total wall "
      f"{t_search+t_bucket+t_align+t_stats:.1f}s")
