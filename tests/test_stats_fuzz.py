"""Randomized stage-3 fuzz vs the live reference stats binary.

Complements the fixed golden fixtures (tests/test_reporter.py): random
planted-duplication genomes with N-runs flow through OUR search/bucket/
align stages to produce realistic aligned.bed rows, then the REFERENCE
``stats generate`` (stats_main.cc compiled from /root/reference with the
fakeboost stubs) and our reporter process the same inputs — exercising
subhit / split_alignment / canonical swap / JC-K2P columns on inputs no
fixture pinned.
"""

import pathlib
import subprocess

import numpy as np
import pytest

from sedef_tpu.config import DEFAULT
from sedef_tpu.io.fasta import FastaReference, generate_translation, write_fai
from sedef_tpu.models import pipeline as pl
from sedef_tpu.models import reporter
from sedef_tpu.models.genome_sim import simulate_genome, write_fasta
from sedef_tpu.ops.wavefront import WavefrontAligner

_ORACLE = "/tmp/sedef_stats_oracle"
_REF = "/root/reference"


@pytest.fixture(scope="session")
def stats_oracle():
    if not pathlib.Path(_REF).exists():  # pragma: no cover
        pytest.skip("reference sources not mounted")
    if not pathlib.Path(_ORACLE).exists():
        oracles = (pathlib.Path(__file__).resolve().parent.parent
                   / "tools" / "oracles")
        srcs = ["stats_main.cc", "align.cc", "hit.cc", "hash.cc",
                "fasta.cc", "globals.cc", "merge.cc"]
        cmd = (["g++", "-std=c++14", "-O2", "-msse4.1", "-include",
                "algorithm", f"-I{_REF}/src", f"-I{_REF}",
                f"-I{oracles}/fakeboost", str(oracles / "stats_oracle.cc")]
               + [f"{_REF}/src/{s}" for s in srcs]
               + [f"{_REF}/extern/format.cc",
                  f"{_REF}/extern/ksw2_extz2_sse.cc", "-o", _ORACLE])
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:  # pragma: no cover
            pytest.skip(f"oracle build failed: {r.stderr[-300:]}")
    return _ORACLE


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_stats_rows_fuzz_vs_reference(stats_oracle, tmp_path, seed):
    chroms, _ = simulate_genome(900_000, 8, sd_min=1500, sd_max=9000,
                                seed=seed, n_chroms=2,
                                n_run_every=120_000,
                                repeat_families=3, repeat_copies=8,
                                repeat_div=(0.05, 0.25))
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, chroms)
    write_fai(fa)
    fr = FastaReference(fa)
    bins = generate_translation(fr)
    seeds = pl.search_stage(fr, bins, DEFAULT, use_device=False)
    buckets = pl.bucket_stage(seeds, fr, bins, 4, DEFAULT)
    flat = [line for b in buckets for line in b]
    aligned = pl.canonical_sort_uniq(pl.align_stage(
        flat, fr, DEFAULT, WavefrontAligner(use_device=False)))
    assert len(aligned) >= 8, "fuzz genome produced too few alignments"
    bed = tmp_path / "aligned.bed"
    bed.write_text("\n".join(aligned) + "\n")

    ref = subprocess.run([stats_oracle, fa, str(bed)],
                         capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-300:]
    ref_rows = [ln for ln in ref.stdout.splitlines()
                if ln.strip() and not ln.startswith("#")]

    ours = reporter.stats_rows(aligned, fr, DEFAULT)
    assert ours == ref_rows
    assert len(ours) >= 8
