"""Crash-consistency of the resumable pipeline (VERDICT r4 Weak #1).

A dead attempt must never poison a resume: ``.ok`` sentinels carry a
content manifest validated at resume, stages wipe their partial outputs
before rerunning, and an empty stage output from non-empty input aborts
instead of being certified (the reference's audit-and-abort discipline,
sedef.sh:145-149, extended to content)."""

import os

import numpy as np
import pytest

from sedef_tpu.parallel.distributed import (guard_nonempty, manifest_of,
                                            ok_valid, wipe_stage, write_ok)


def _mk(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def test_manifest_roundtrip(tmp_path):
    art = _mk(tmp_path, "a.bed", "r1\nr2\nr3\n")
    ok = str(tmp_path / "a.ok")
    write_ok(ok, art)
    assert manifest_of(art)["rows"] == 3
    assert ok_valid(ok, art)
    # truncation invalidates
    open(art, "w").write("r1\n")
    assert not ok_valid(ok, art)
    # same-size corruption invalidates (CRC, not just size)
    open(art, "w").write("r1\nr2\nrX\n")
    assert not ok_valid(ok, art)


def test_legacy_empty_sentinel_is_invalid(tmp_path):
    """Pre-r5 sentinels were empty files: they certify nothing and must
    force a rerun, not a resume."""
    art = _mk(tmp_path, "a.bed", "r1\n")
    ok = str(tmp_path / "a.ok")
    open(ok, "w").close()
    assert not ok_valid(ok, art)


def test_missing_artifact_is_invalid(tmp_path):
    art = _mk(tmp_path, "a.bed", "r1\n")
    ok = str(tmp_path / "a.ok")
    write_ok(ok, art)
    os.unlink(art)
    assert not ok_valid(ok, art)


def test_guard_nonempty():
    guard_nonempty("x", 5, 10)       # fine
    guard_nonempty("x", 0, 0)        # empty input: fine
    with pytest.raises(RuntimeError, match="0 rows from 10"):
        guard_nonempty("x", 0, 10)
    os.environ["SEDEF_ALLOW_EMPTY"] = "1"
    try:
        guard_nonempty("x", 0, 10)   # explicit override
    finally:
        del os.environ["SEDEF_ALLOW_EMPTY"]


def test_wipe_stage_scopes_to_pid(tmp_path):
    art = _mk(tmp_path, "seeds.bed", "r\n")
    _mk(tmp_path, "seeds.ok", "{}")
    _mk(tmp_path, "seeds.bed.tmp.0", "partial")
    _mk(tmp_path, "seeds.spool.0", "spool")
    _mk(tmp_path, "seeds.spool.1", "other live process")
    wipe_stage(str(tmp_path), "seeds", [art], pid=0)
    assert not os.path.exists(art)
    assert not (tmp_path / "seeds.ok").exists()
    assert not (tmp_path / "seeds.bed.tmp.0").exists()
    assert not (tmp_path / "seeds.spool.0").exists()
    assert (tmp_path / "seeds.spool.1").exists()  # pid 1's, maybe live


def _planted_genome(tmp_path, seed=29):
    rng = np.random.default_rng(seed)
    bg = rng.choice(np.array(list("acgt")), 15000)
    seg = "".join(rng.choice(np.array(list("ACGT")), 1500))
    chrom = ("".join(bg[:3000]) + seg + "".join(bg[3000:9000]) + seg
             + "".join(bg[9000:]))
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        f.write(">chrP\n")
        for i in range(0, len(chrom), 70):
            f.write(chrom[i:i + 70] + "\n")
    return str(fa)


def test_poisoned_resume_recovers(tmp_path):
    """The r4 incident, reproduced deliberately: a dead attempt left an
    EMPTY aligned.bed with a (legacy) sentinel.  The resumed pipeline
    must detect the poison, rerun the align stage, and produce the same
    final.bed as a fresh run — not exit 0 with a header-only final."""
    from sedef_tpu.models.pipeline import run_pipeline
    from sedef_tpu.ops.wavefront import WavefrontAligner

    fa = _planted_genome(tmp_path)
    al = WavefrontAligner(use_device=False)
    ref = run_pipeline(fa, str(tmp_path / "ref"), nbuckets=2, aligner=al)
    ref_final = open(ref["final"]).read()
    assert len(ref_final.splitlines()) >= 2

    out = tmp_path / "out"
    paths = run_pipeline(fa, str(out), nbuckets=2, aligner=al)
    # poison: empty aligned.bed + contentless sentinel; drop final
    open(out / "aligned.bed", "w").close()
    open(out / "aligned.ok", "w").close()
    os.unlink(out / "final.bed")
    os.unlink(out / "final.ok")

    paths = run_pipeline(fa, str(out), nbuckets=2, aligner=al)
    assert open(paths["final"]).read() == ref_final


def test_self_consistent_empty_artifact_refused(tmp_path):
    """Even a sentinel whose manifest MATCHES an empty aligned.bed (the
    only state a degraded-collective attempt could have certified) is
    refused at resume: the empty-from-nonempty audit fires."""
    from sedef_tpu.models.pipeline import run_pipeline
    from sedef_tpu.ops.wavefront import WavefrontAligner

    fa = _planted_genome(tmp_path)
    al = WavefrontAligner(use_device=False)
    out = tmp_path / "out"
    run_pipeline(fa, str(out), nbuckets=2, aligner=al)
    open(out / "aligned.bed", "w").close()
    write_ok(str(out / "aligned.ok"), str(out / "aligned.bed"))
    os.unlink(out / "final.bed")
    os.unlink(out / "final.ok")
    with pytest.raises(RuntimeError, match="align \\(resumed\\)"):
        run_pipeline(fa, str(out), nbuckets=2, aligner=al)


def test_truncated_seeds_rerun_byte_identical(tmp_path):
    """Truncating seeds.bed after a complete run invalidates its
    manifest; the resume rebuilds stage 1 and the restored file is
    byte-identical."""
    from sedef_tpu.models.pipeline import run_pipeline
    from sedef_tpu.ops.wavefront import WavefrontAligner

    fa = _planted_genome(tmp_path)
    al = WavefrontAligner(use_device=False)
    out = tmp_path / "out"
    paths = run_pipeline(fa, str(out), nbuckets=2, aligner=al)
    seeds_before = open(paths["seeds"]).read()
    with open(paths["seeds"], "w") as f:
        f.write(seeds_before[:len(seeds_before) // 2])
    run_pipeline(fa, str(out), nbuckets=2, aligner=al, force=False)
    assert open(paths["seeds"]).read() == seeds_before
