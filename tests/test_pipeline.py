"""End-to-end pipeline on a synthetic soft-masked genome, and the
simulation-based accuracy harness (the reference's own QA model,
paper/output-rand.txt semantics at reduced scale)."""

import random

import numpy as np
import pytest

from sedef_tpu.config import Config
from sedef_tpu.models.pipeline import canonical_sort_uniq, run_pipeline
from sedef_tpu.models.simulate import classify_pair, generate_random_sd
from sedef_tpu.ops.wavefront import WavefrontAligner


def _make_genome(tmp_path, rng):
    """One chromosome: lowercase background with two uppercase ~2.5 kbp
    duplicate segments (~4% mutations) planted at known positions."""
    bases = np.array(list("acgt"))
    bg = rng.choice(bases, 30000)
    seg = "".join(rng.choice(np.array(list("ACGT")), 2500))
    seg2 = list(seg)
    mut = rng.random(len(seg2)) < 0.04
    ACGT = list("ACGT")
    for i in np.nonzero(mut)[0]:
        seg2[i] = ACGT[(ACGT.index(seg2[i]) + int(rng.integers(1, 4))) % 4]
    seg2 = "".join(seg2)
    chrom = ("".join(bg[:5000]) + seg + "".join(bg[5000:15000]) + seg2
             + "".join(bg[15000:]))
    pos1 = (5000, 5000 + len(seg))
    pos2 = (5000 + len(seg) + 10000, 5000 + len(seg) + 10000 + len(seg2))
    fa = tmp_path / "toy.fa"
    with open(fa, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(chrom), 60):
            f.write(chrom[i:i + 60] + "\n")
    return str(fa), pos1, pos2


def _overlap(a, b):
    return max(0, min(a[1], b[1]) - max(a[0], b[0]))


def test_pipeline_finds_planted_duplication(tmp_path):
    rng = np.random.default_rng(11)
    fa, pos1, pos2 = _make_genome(tmp_path, rng)
    out = run_pipeline(fa, str(tmp_path / "out"), nbuckets=4,
                       aligner=WavefrontAligner(use_device=False))
    final = open(out["final"]).read().splitlines()
    assert final[0].startswith("#chr1\t")
    rows = [l.split("\t") for l in final[1:]]
    assert rows, "no final SD calls"
    found = False
    for f in rows:
        assert len(f) == 34, f"expected 34 columns, got {len(f)}"
        q = (int(f[1]), int(f[2]))
        r = (int(f[4]), int(f[5]))
        cov_q = _overlap(q, pos1) / (pos1[1] - pos1[0])
        cov_r = _overlap(r, pos2) / (pos2[1] - pos2[0])
        if cov_q > 0.8 and cov_r > 0.8:
            found = True
            # sanity of the stats columns
            frac_match = float(f[20])
            assert 0.90 < frac_match < 1.0
            assert f[8] == "+" and f[9] == "+"
    assert found, f"planted pair not found in: {final[1:]}"
    # seeds and aligned intermediates exist and are non-trivial
    assert open(out["seeds"]).read().strip()
    assert open(out["aligned"]).read().strip()


def test_pipeline_finds_inverted_duplication(tmp_path):
    """Reverse-complement (strand '-') duplications must be detected too."""
    from sedef_tpu.ops.dna import revcomp
    rng = np.random.default_rng(5)
    bases = np.array(list("acgt"))
    bg = rng.choice(bases, 24000)
    seg = "".join(rng.choice(np.array(list("ACGT")), 2200))
    chrom = ("".join(bg[:4000]) + seg + "".join(bg[4000:12000])
             + revcomp(seg) + "".join(bg[12000:]))
    fa = tmp_path / "inv.fa"
    with open(fa, "w") as f:
        f.write(">chrI\n")
        for i in range(0, len(chrom), 80):
            f.write(chrom[i:i + 80] + "\n")
    out = run_pipeline(str(fa), str(tmp_path / "out"), nbuckets=2,
                       aligner=WavefrontAligner(use_device=False))
    rows = [l.split("\t") for l in
            open(out["final"]).read().splitlines()[1:]]
    assert any(f[9] == "-" for f in rows), "inverted SD not called"


def test_canonical_sort_uniq():
    lines = [
        "chr10\t5\t9\tchr2\t1\t2\tx\t\t+\t-\t0\t0\t\t",
        "chr2\t5\t9\tchr2\t1\t2\tx\t\t+\t+\t0\t0\t\t",
        "chr2\t5\t9\tchr2\t1\t2\tx\t\t+\t+\t0\t0\t\t",  # dup
        "chr2\t3\t9\tchr2\t1\t2\tx\t\t+\t-\t0\t0\t\t",
    ]
    out = canonical_sort_uniq(lines)
    assert len(out) == 3
    # chr2 before chr10 (version sort); '-' strand before '+' (reverse)
    assert out[0].startswith("chr2\t3")
    assert out[1].startswith("chr2\t5")
    assert out[2].startswith("chr10")


@pytest.mark.parametrize("error", [0, 10, 25])
def test_simulation_accuracy(error):
    """Reduced-scale port of the reference accuracy harness
    (simulations.py + paper/output-rand.txt: >=99% hits at every error
    rate).  5 pairs per rate at 1-6 Kbp keeps CI fast."""
    rng = random.Random(100 + error)
    al = WavefrontAligner(use_device=False)
    results = []
    for _ in range(5):
        s1, s2, _ = generate_random_sd(rng, error, min_len=1200,
                                       max_len=6000)
        results.append(classify_pair(s1, s2, error, aligner=al))
    assert results.count("hit") >= 4, results


def test_bucket_stage_spill_matches_memory(tmp_path):
    """Disk-spill bucket mode (align_main.cc:89-106) must produce exactly
    the in-memory result, including at >= 10 super-bins where the
    reference's lexicographic tmp-filename order diverges from numeric
    (bi, bj) order."""
    from sedef_tpu.config import DEFAULT
    from sedef_tpu.io.fasta import FastaReference, generate_translation
    from sedef_tpu.models import pipeline as pl

    rng = np.random.default_rng(3)
    # 12 small chromosomes -> 12 super-bins with max_size=1
    chroms = {}
    seed_lines = []
    core = "".join(rng.choice(np.array(list("ACGT")), 1200))
    for ci in range(12):
        name = f"chr{ci + 1}"
        bg = "".join(rng.choice(np.array(list("acgt")), 4000))
        chroms[name] = bg[:1500] + core + bg[1500:]
    fa = tmp_path / "multi.fa"
    with open(fa, "w") as f:
        for name, seq in chroms.items():
            f.write(f">{name}\n{seq}\n")
    fr = FastaReference(str(fa))
    bins = generate_translation(fr, max_size=1)
    assert len(bins) >= 10, "test needs >= 10 super-bins"
    names = list(chroms)
    for a in range(len(names)):
        for b in range(a, len(names)):
            s = int(rng.integers(1500, 1800))
            seed_lines.append(
                f"{names[a]}\t{s}\t{s + 900}\t{names[b]}\t1500\t2400\t"
                f"S\t0\t+\t+\t900\tOK")

    mem = pl.bucket_stage(list(seed_lines), fr, bins, 7, DEFAULT)
    spill = pl.bucket_stage(iter(seed_lines), fr, bins, 7, DEFAULT,
                            tmp_dir=str(tmp_path / "spill"))
    assert mem == spill
    assert sum(len(b) for b in mem) > 0
    # tmp files are cleaned up
    import glob as _g
    assert not _g.glob(str(tmp_path / "spill" / "tmp_*"))


def test_bucket_stage_lexicographic_bin_order():
    """Key iteration follows the reference's map<string, FILE*> order:
    ASCII '0' < '_', so tmp_10_0.tmp sorts before tmp_1_2.tmp, which
    sorts before tmp_2_0.tmp."""
    from sedef_tpu.models.pipeline import _tmp_bin_name
    keys = [(2, 0), (10, 0), (1, 11), (1, 2)]
    ordered = sorted(keys, key=_tmp_bin_name)
    assert ordered == [(10, 0), (1, 11), (1, 2), (2, 0)]


def test_index_cache_lru_eviction(tmp_path):
    """A byte-capped IndexCache evicts LRU entries yet search output stays
    identical — evicted chromosomes are rebuilt on re-touch."""
    from sedef_tpu.config import DEFAULT
    from sedef_tpu.io.fasta import FastaReference, generate_translation
    from sedef_tpu.models.genome_sim import simulate_genome, write_fasta
    from sedef_tpu.models.pipeline import IndexCache, search_stage

    chroms, _ = simulate_genome(400_000, 4, n_chroms=4, seed=5)
    fa = tmp_path / "g.fa"
    write_fasta(str(fa), chroms)
    fr = FastaReference(str(fa))
    # tiny bins so many (bin_i, bin_j) jobs touch many chromosomes
    bins = generate_translation(fr, max_size=120_000)
    assert len(bins) >= 3

    unbounded = IndexCache(fr, DEFAULT, use_device=False)
    seeds_ref = search_stage(fr, bins, DEFAULT, use_device=False,
                             cache=unbounded)
    assert unbounded.evictions == 0

    capped = IndexCache(fr, DEFAULT, use_device=False,
                        max_bytes=1_500_000)  # ~2 entries of ~700 KB
    seeds_lru = search_stage(fr, bins, DEFAULT, use_device=False,
                             cache=capped)
    assert capped.evictions > 0
    assert capped._bytes <= capped.max_bytes or len(capped._cache) == 1
    assert seeds_lru == seeds_ref


def test_search_stage_sink_streams_identical(tmp_path):
    """sink mode streams per-job seed lines in deterministic job order and
    returns the total count — byte-identical to the list mode."""
    from sedef_tpu.config import DEFAULT
    from sedef_tpu.io.fasta import FastaReference, generate_translation
    from sedef_tpu.models.genome_sim import simulate_genome, write_fasta
    from sedef_tpu.models.pipeline import search_stage

    chroms, _ = simulate_genome(400_000, 4, n_chroms=2, seed=6)
    fa = tmp_path / "g.fa"
    write_fasta(str(fa), chroms)
    fr = FastaReference(str(fa))
    bins = generate_translation(fr, max_size=250_000)

    as_list = search_stage(fr, bins, DEFAULT, use_device=False)
    assert len(as_list) > 0

    streamed: list[str] = []
    jobs_seen = []
    n = search_stage(fr, bins, DEFAULT, use_device=False, jobs=2,
                     sink=lambda job: (streamed.extend(job),
                                       jobs_seen.append(len(job))))
    assert n == len(as_list)
    assert streamed == as_list
    assert sum(jobs_seen) == n
