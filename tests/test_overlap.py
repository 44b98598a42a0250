"""Cross-stage overlap (VERDICT r4 item 7): the overlapped driver must
produce byte-identical seeds/aligned/final artifacts to the sequential
stage structure, because both are canonical_sort_uniq'd sets and merge
bins only ever receive hits from their own pair's two strand jobs."""

import numpy as np
import pytest

from sedef_tpu.models.genome_sim import simulate_genome, write_fasta
from sedef_tpu.models.pipeline import run_pipeline
from sedef_tpu.ops.wavefront import WavefrontAligner


@pytest.mark.parametrize("seed,n_chroms", [(41, 3), (42, 1)])
def test_overlapped_equals_sequential(tmp_path, monkeypatch, seed,
                                      n_chroms):
    chroms, _ = simulate_genome(600_000, 6, sd_min=1500, sd_max=5000,
                                seed=seed, n_chroms=n_chroms,
                                repeat_families=2, repeat_copies=6)
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, chroms)
    al = WavefrontAligner(use_device=False)

    monkeypatch.delenv("SEDEF_NO_OVERLAP", raising=False)
    ov = run_pipeline(fa, str(tmp_path / "ov"), nbuckets=3, aligner=al,
                      jobs=2)
    monkeypatch.setenv("SEDEF_NO_OVERLAP", "1")
    sq = run_pipeline(fa, str(tmp_path / "sq"), nbuckets=3, aligner=al,
                      jobs=2)
    for k in ("seeds", "aligned", "final"):
        assert open(ov[k]).read() == open(sq[k]).read(), k
    assert len(open(ov["final"]).read().splitlines()) >= 2


def test_overlapped_resume_uses_sequential_path(tmp_path, monkeypatch):
    """After a completed overlapped run, artifacts resume cleanly (the
    overlapped tail writes the same manifests the sequential path
    validates)."""
    rng = np.random.default_rng(57)
    bg = rng.choice(np.array(list("acgt")), 15000)
    seg = "".join(rng.choice(np.array(list("ACGT")), 1500))
    chrom = ("".join(bg[:3000]) + seg + "".join(bg[3000:9000]) + seg
             + "".join(bg[9000:]))
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        f.write(">chrO\n")
        for i in range(0, len(chrom), 70):
            f.write(chrom[i:i + 70] + "\n")
    al = WavefrontAligner(use_device=False)
    monkeypatch.delenv("SEDEF_NO_OVERLAP", raising=False)
    p1 = run_pipeline(str(fa), str(tmp_path / "out"), nbuckets=2,
                      aligner=al)
    before = open(p1["final"]).read()
    p2 = run_pipeline(str(fa), str(tmp_path / "out"), nbuckets=2,
                      aligner=al)  # full resume, no recompute
    assert open(p2["final"]).read() == before
