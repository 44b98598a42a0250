"""Stage-3 reporter vs the reference stats-generate binary (golden fixture
covering N-run splitting, forward and reverse-complement hits, and the
per-base statistics columns)."""

from sedef_tpu.io.fasta import FastaReference
from sedef_tpu.models import reporter


def test_stats_rows_match_reference(fixtures_dir):
    d = fixtures_dir / "stats"
    golden = (d / "final_golden.txt").read_text().splitlines()
    assert golden[0] == reporter.HEADER
    fr = FastaReference(str(d / "toy.fa"))
    lines = (d / "aligned.bed").read_text().splitlines()
    rows = reporter.stats_rows(lines, fr)
    assert rows == golden[1:]


def test_stats_rows_gap_split_mode(fixtures_dir):
    """max_ok_gap enabled exercises the recursive gap_split path
    (stats_main.cc:87-157); golden from the reference binary."""
    from sedef_tpu.config import Config
    cfg = Config().finalize()
    cfg.stats.max_ok_gap = 5
    d = fixtures_dir / "stats"
    golden = (d / "final_golden_gap5.txt").read_text().splitlines()
    fr = FastaReference(str(d / "toy.fa"))
    rows = reporter.stats_rows((d / "aligned.bed").read_text().splitlines(),
                               fr, cfg)
    assert rows == golden[1:]


def test_stats_rows_parallel_matches_serial(fixtures_dir):
    """jobs>1 stats fan-out (stats_main.cc:386-391 equivalent) emits the
    exact same rows as the serial path."""
    import pathlib
    import tempfile

    import numpy as np

    from sedef_tpu.config import DEFAULT
    from sedef_tpu.io.fasta import FastaReference, generate_translation
    from sedef_tpu.models import pipeline as pl
    from sedef_tpu.models import reporter
    from sedef_tpu.models.genome_sim import simulate_genome, write_fasta
    from sedef_tpu.ops.wavefront import WavefrontAligner

    chroms, _ = simulate_genome(1_500_000, 8, seed=2)
    tmp = tempfile.mkdtemp()
    fa = tmp + "/g.fa"
    write_fasta(fa, chroms)
    fr = FastaReference(fa)
    bins = generate_translation(fr)
    seeds = pl.search_stage(fr, bins, DEFAULT)
    buckets = pl.bucket_stage(seeds, fr, bins, 4, DEFAULT)
    flat = [ln for b in buckets for ln in b]
    aligned = pl.canonical_sort_uniq(pl.align_stage(
        flat, fr, DEFAULT, WavefrontAligner(use_device=False)))
    serial = reporter.stats_rows(aligned, fr, DEFAULT)
    par = reporter.stats_rows(aligned, fr, DEFAULT, jobs=4)
    assert serial == par
    assert len(serial) > 0
