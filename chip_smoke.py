#!/usr/bin/env python
"""Run the SEDEF pipeline end to end on one GPU and check it against the
host path.  Run from the root of a checkout:

    python chip_smoke.py            # one GPU: phases A, B, C
    python chip_smoke.py --multi    # every visible GPU (four): mesh phase

Phases (each failure exits non-zero; nothing is caught and ignored):

A. Kernel: the gap-DP device route (CUDA kernel) compiled for the card at
   every size class, bit-identical to the NumPy reference
   (``wavefront_np`` + ``backtrack_np``), the native scalar DP, the plain
   JAX route on the card, and the ksw2 golden fixtures; then the tests
   marked ``gpu``, in this process.
B. Main path: a seeded ~50 Mbp, 4-chromosome genome with planted SDs and
   repeat families through ``run_pipeline`` with the default aligner (the
   path of ``python -m sedef_tpu.cli pipeline``); align and stats re-run
   on the same seeds with the host-only aligner must give byte-identical
   ``aligned.bed`` and ``final.bed``.
C. Opt-in stage-1 device ops (device index build, forced prefilter) on
   one chromosome pair of that genome: seeds identical to the host run,
   and the prefilter proves intervals dead (fewer host roll steps).

``--multi`` runs only phase B's genome through ``MeshAligner`` over all
cards and through the single-card aligner, and compares ``final.bed``.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# the deployment of phase B: genome scale of human chr21/chr22 runs
GENOME = dict(length=50_000_000, n_sds=60, sd_min=1500, sd_max=40_000,
              max_divergence=0.12, n_chroms=4, seed=2024,
              repeat_families=20, repeat_copies=40)
# size classes of phase A: (S_q, S_t, problems)
CLASSES = [(128, 128, 512), (256, 256, 512), (512, 512, 264),
           (1024, 1024, 264), (2048, 2048, 132), (4096, 4096, 132),
           (8192, 8192, 33), (1024, 2048, 132), (2048, 512, 132)]


def say(*args) -> None:
    print(*args, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def mutated_pairs(rng, S_q: int, S_t: int, n: int):
    """``n`` related (query, target) code pairs with lengths in
    (S/2, S] and ~10% substitutions, some with indels."""
    import numpy as np
    pairs = []
    for _ in range(n):
        ql = int(rng.integers(S_q // 2 + 1, S_q + 1))
        tl = int(rng.integers(S_t // 2 + 1, S_t + 1))
        src = rng.integers(0, 4, max(ql, tl) + 64).astype(np.int8)
        q = src[:ql].copy()
        cut = int(rng.integers(0, 32))
        t = np.concatenate([src[:tl // 2], src[tl // 2 + cut:]])[:tl]
        t = np.concatenate([t, rng.integers(0, 4, tl - len(t))]).astype(
            np.int8)
        m = rng.random(tl) < 0.1
        t[m] = rng.integers(0, 4, int(m.sum()))
        pairs.append((q, t))
    return pairs


def ksw2_fixture(path: pathlib.Path):
    """(query codes, target codes, CIGAR) of a ksw2 golden fixture."""
    import numpy as np
    lines = path.read_text().splitlines()
    return [(np.array([int(c) for c in lines[i + 1]], np.int8),
             np.array([int(c) for c in lines[i + 2]], np.int8),
             lines[i + 3]) for i in range(0, len(lines), 4)]


def phase_a() -> None:
    import jax
    import numpy as np
    import pytest

    from sedef_tpu.native import cuda
    from sedef_tpu.native import lib as native
    from sedef_tpu.ops.wavefront import (DEVICE_MAX_CLASS, _pad_to_class,
                                         backtrack_np, cigar_from_packed_ops,
                                         gap_dp_packed, pack_class_batch,
                                         wavefront_cigar_scan, wavefront_np)

    t0 = time.perf_counter()
    cuda.load()
    say(f"[A] CUDA gap-DP library ready in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(7)
    for S_q, S_t, n in CLASSES:
        pairs = mutated_pairs(rng, S_q, S_t, n)
        args = pack_class_batch(pairs, range(n), S_q, S_t, n)
        t0 = time.perf_counter()
        ops = np.asarray(gap_dp_packed(*args, S_q, S_t, cuda=True))
        t_first = time.perf_counter() - t0
        got = [cigar_from_packed_ops(ops[i], len(q), len(t))
               for i, (q, t) in enumerate(pairs)]
        host = native.align_batch(
            [(q.astype(np.uint8), t.astype(np.uint8)) for q, t in pairs],
            5, -4, 40, 1)
        assert got == host, f"class ({S_q}, {S_t}): CUDA != native DP"
        n_np = 4 if S_t <= 1024 else 1
        for i, (q, t) in enumerate(pairs[:n_np]):
            p, _ = wavefront_np(q, t)
            assert got[i] == backtrack_np(p, len(q), len(t)), (
                f"class ({S_q}, {S_t}): CUDA != NumPy")
        n_plain = min(n, 8 if S_t <= 2048 else 2)
        plain = np.asarray(wavefront_cigar_scan(
            *(a[:n_plain] for a in args), S_q, S_t))
        assert np.array_equal(plain, ops[:n_plain]), (
            f"class ({S_q}, {S_t}): CUDA != plain JAX route")
        say(f"[A] class ({S_q}, {S_t}): {n} problems bit-identical to the "
            f"native DP, {n_np} to NumPy, {n_plain} to the plain route "
            f"(first call {t_first:.2f}s)")
    step = jax.jit(lambda *a: gap_dp_packed(*a, 1024, 1024, cuda=True))
    mem = step.lower(*pack_class_batch(
        mutated_pairs(rng, 1024, 1024, 264), range(264), 1024, 1024,
        264)).compile().memory_analysis()
    say(f"[A] memory_analysis (1024, 1024) x 264: {mem}")

    for name in ("ksw2_pairs_1", "ksw2_pairs_2"):
        fx = ksw2_fixture(ROOT / "tests" / "fixtures" / f"{name}.txt")
        S_q = _pad_to_class(max(len(q) for q, _, _ in fx))
        S_t = _pad_to_class(max(len(t) for _, t, _ in fx))
        assert max(S_q, S_t) <= DEVICE_MAX_CLASS
        ops = np.asarray(gap_dp_packed(
            *pack_class_batch([(q, t) for q, t, _ in fx], range(len(fx)),
                              S_q, S_t, len(fx)), S_q, S_t, cuda=True))
        for i, (q, t, want) in enumerate(fx):
            cig = cigar_from_packed_ops(ops[i], len(q), len(t))
            assert "".join(f"{ln}{op}" for op, ln in cig) == want, name
        say(f"[A] ksw2 fixtures {name}: {len(fx)} CIGARs identical")

    # the tests run in this process, which holds the card
    os.environ["SEDEF_TESTS_ON_CARD"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(ROOT / "tests")])
    assert rc == 0, f"gpu-marked tests failed (pytest rc {rc})"
    say("[A] gpu-marked tests passed")


def make_genome(work: pathlib.Path) -> str:
    from sedef_tpu.models.genome_sim import simulate_genome, write_fasta
    t0 = time.perf_counter()
    chroms, planted = simulate_genome(**GENOME)
    fa = str(work / "genome.fa")
    write_fasta(fa, chroms)
    say(f"[genome] {GENOME['length'] / 1e6:.0f} Mbp, "
        f"{len(chroms)} chromosomes, {len(planted)} planted SDs: "
        f"{time.perf_counter() - t0:.1f}s (set-up)")
    return fa


def run(fa: str, out: pathlib.Path, aligner, jobs: int, label: str
        ) -> dict:
    from sedef_tpu.models.pipeline import run_pipeline
    walls: dict[str, float] = {}
    t0 = time.perf_counter()
    paths = run_pipeline(fa, str(out), aligner=aligner, jobs=jobs,
                         walls=walls)
    walls["total"] = time.perf_counter() - t0
    say(f"[run] {label}: " + ", ".join(f"{k} {v:.2f}s"
                                       for k, v in walls.items()))
    return paths


def rerun_from_seeds(fa: str, done: pathlib.Path, out: pathlib.Path,
                     aligner, jobs: int, label: str) -> dict:
    """Align and stats again on the seeds of run ``done``."""
    out.mkdir(parents=True)
    for name in ("seeds.bed", "seeds.ok"):
        shutil.copy(done / name, out / name)
    return run(fa, out, aligner, jobs, label)


def same_outputs(a: dict, b: dict, what: str) -> None:
    for key in ("aligned", "final"):
        da = pathlib.Path(a[key]).read_bytes()
        db = pathlib.Path(b[key]).read_bytes()
        assert da == db, f"{what}: {key}.bed differs"
    rows = pathlib.Path(a["final"]).read_text().count("\n") - 1
    assert rows > 0, "final.bed is empty"
    say(f"[check] {what}: aligned.bed and final.bed byte-identical "
        f"({rows} final SDs)")


def phase_b(work: pathlib.Path, fa: str) -> None:
    from sedef_tpu import devcal
    from sedef_tpu.ops.cigar import default_aligner
    from sedef_tpu.ops.wavefront import WavefrontAligner

    jobs = os.cpu_count() or 1
    say(f"[B] card: {card()}; jobs={jobs}")
    say(f"[B] devcal on this card: {devcal.apply()}")
    al = default_aligner()
    dev = run(fa, work / "device", al, jobs, "device run (search + "
              "overlapped align/stats)")
    say(f"[B] device route took {al.device_problems} gap-DP problems, "
        f"{al.device_cells} cells")
    assert al.device_problems > 0 and al.device_cells > 0, (
        "no gap DP reached the device")
    host = rerun_from_seeds(fa, work / "device", work / "host",
                            WavefrontAligner(use_device=False), jobs,
                            "host-only align + stats on the same seeds")
    same_outputs(dev, host, "device vs host-only aligner")


def phase_c(fa: str) -> None:
    import numpy as np

    from sedef_tpu.config import DEFAULT
    from sedef_tpu.io.fasta import FastaReference
    from sedef_tpu.models import pipeline as pl
    from sedef_tpu.models import seeder
    from sedef_tpu.native import lib as native
    from sedef_tpu.ops.dna import PackedSeq
    from sedef_tpu.ops.index import MinimizerIndex
    from sedef_tpu.ops.winnow_device import device_index_arrays

    fr = FastaReference(fa)
    c1, c2 = fr.order[:2]
    k, w = DEFAULT.search.kmer_size, DEFAULT.search.window_size
    t0 = time.perf_counter()
    seq = PackedSeq(c1, fr.get_sequence(c1))
    dev = device_index_arrays(seq.code, seq.cls, k, w)
    assert dev is not None, "device index build did not apply"
    host = MinimizerIndex(seq, k, w)
    for name, d in zip(("keys", "locs", "skeys", "slocs"), dev):
        assert np.array_equal(np.asarray(d), getattr(host, name)), name
    say(f"[C] device index build of {c1} ({len(dev[0])} minimizers) "
        f"identical to the host index: {time.perf_counter() - t0:.1f}s")

    # the pair job (c2 vs c1), both strands, on the whole-job path that
    # dispatches the device engines
    bins = [[c1], [c2]]
    todo = [(1, 0, False), (1, 0, True)]

    def seeds(use_device: bool, prefilter: bool) -> tuple[list[str], int]:
        """Seeds and the native core's host roll steps."""
        seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS = prefilter, 0
        native.prof_reset()
        t0 = time.perf_counter()
        rows = pl.search_stage(fr, bins, DEFAULT, use_device=use_device,
                               jobs=2, shard_bp=0, todo=todo)
        steps = int(native.prof_get()["roll_steps"])
        say(f"[C] stage 1 {c2} x {c1} use_device={use_device} "
            f"prefilter={prefilter}: {len(rows)} seeds, {steps} host roll "
            f"steps, {time.perf_counter() - t0:.1f}s")
        return rows, steps

    old = seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS
    try:
        want, host_steps = seeds(False, False)
        got, index_steps = seeds(True, False)
        assert want, "no seeds"
        assert got == want, "device index path changed the seeds"
        assert index_steps == host_steps
        got, pruned_steps = seeds(True, True)
        assert got == want, "forced prefilter changed the seeds"
    finally:
        seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS = old
    # the device bound must have proven some intervals dead: a prefilter
    # whose verdicts are all "roll on host" gives the same seeds too
    assert pruned_steps < host_steps, "the device prefilter pruned nothing"
    say(f"[C] device index build and forced prefilter: seeds identical; "
        f"prefilter cut host roll steps {host_steps} -> {pruned_steps}")


def phase_multi(work: pathlib.Path, fa: str) -> None:
    import jax

    from sedef_tpu.ops.wavefront import WavefrontAligner
    from sedef_tpu.parallel.mesh import MeshAligner

    jobs = os.cpu_count() or 1
    say(f"[multi] cards: {card()}; jobs={jobs}")
    mesh = jax.make_mesh((len(jax.devices()),), ("data",))
    al = MeshAligner(mesh)
    multi = run(fa, work / "mesh", al, jobs, f"MeshAligner over "
                f"{len(jax.devices())} cards")
    say(f"[multi] device route took {al.device_problems} gap-DP problems, "
        f"{al.device_cells} cells")
    assert al.device_problems > 0
    one = rerun_from_seeds(fa, work / "mesh", work / "single",
                           WavefrontAligner(), jobs,
                           "single-card align + stats on the same seeds")
    same_outputs(multi, one, "MeshAligner vs single card")
    # the same align + stats rerun over the mesh: walls comparable with
    # the single-card rerun above
    again = rerun_from_seeds(fa, work / "mesh", work / "mesh_rerun",
                             MeshAligner(mesh), jobs,
                             "MeshAligner align + stats on the same seeds")
    same_outputs(again, one, "MeshAligner rerun vs single card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run phase B's genome over all visible cards")
    args = ap.parse_args()

    import jax

    from sedef_tpu.device import accelerator
    from sedef_tpu.native import build

    dev = accelerator()
    if dev is None:
        print("chip_smoke: JAX finds no GPU", file=sys.stderr)
        return 1
    build.build(verbose=False)
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        fa = make_genome(work)
        if args.multi:
            phase_multi(work, fa)
        else:
            phase_a()
            phase_b(work, fa)
            phase_c(fa)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(card())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
