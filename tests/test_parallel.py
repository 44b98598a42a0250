"""Multi-chip sharded step on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from sedef_tpu.ops.filter import _qgram_hist, min_qgram
from sedef_tpu.parallel.mesh import (build_multichip_step, example_inputs,
                                     make_mesh, qgram_scores)


def test_mesh_shape():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("pairs", "data")


def test_qgram_scores_match_host():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, (3, 100)).astype(np.uint8)
    b = rng.integers(0, 4, (3, 100)).astype(np.uint8)
    got = np.asarray(qgram_scores(a, b))
    for i in range(3):
        ha = _qgram_hist(a[i])
        hb = _qgram_hist(b[i])
        assert got[i] == int(np.minimum(ha, hb).sum())


def test_multichip_step_runs():
    mesh = make_mesh(8)
    step = build_multichip_step(mesh, S_q=128, S_t=128)
    args = example_inputs(mesh)
    ops, mcols, qg, total, total_passed, counts = step(*args)
    jax.block_until_ready(ops)
    pp, dd = mesh.devices.shape
    assert int(total) == pp * dd * 2
    assert 0 <= int(total_passed) <= int(total)
    assert counts.shape == (pp, dd)
    assert ops.shape[:3] == (pp, dd, 2)
    # every problem consumed rows: matched columns are counted per problem
    assert (np.asarray(mcols) > 0).all()


def test_scan_matches_numpy_reference():
    from sedef_tpu.ops.wavefront import (backtrack_np, wavefront_np,
                                         wavefront_scan_batch)
    rng = np.random.default_rng(4)
    ql, tl = 90, 100
    q = rng.integers(0, 4, ql).astype(np.int8)
    t = rng.integers(0, 4, tl).astype(np.int8)
    S = 128
    qc = np.full((1, S + S - 1), 4, np.int32)
    qc[0, :ql] = q
    tp = np.full((1, S), 4, np.int8)
    tp[0, :tl] = t
    p_dev = np.asarray(wavefront_scan_batch(qc, tp, S, S))[0]
    p_ref, _ = wavefront_np(q, t)
    assert backtrack_np(p_dev, ql, tl) == backtrack_np(p_ref, ql, tl)


def test_distributed_degenerate(tmp_path):
    """Distributed pipeline in single-process mode == plain pipeline."""
    from sedef_tpu.parallel.distributed import (gather_lines,
                                                run_pipeline_distributed)
    assert gather_lines(["a", "b"]) == ["a", "b"]
    rng = np.random.default_rng(2)
    bg = rng.choice(np.array(list("acgt")), 15000)
    seg = "".join(rng.choice(np.array(list("ACGT")), 1500))
    chrom = ("".join(bg[:3000]) + seg + "".join(bg[3000:9000]) + seg
             + "".join(bg[9000:]))
    fa = tmp_path / "d.fa"
    with open(fa, "w") as f:
        f.write(">chrD\n")
        for i in range(0, len(chrom), 70):
            f.write(chrom[i:i + 70] + "\n")
    from sedef_tpu.ops.wavefront import WavefrontAligner
    al = WavefrontAligner(use_device=False)
    paths = run_pipeline_distributed(str(fa), str(tmp_path / "outd"),
                                     nbuckets=2, aligner=al)
    rows = open(paths["final"]).read().splitlines()
    assert len(rows) >= 2  # header + the planted identical pair


def test_distributed_two_processes(tmp_path):
    """Real 2-process jax.distributed run: final.bed must be byte-identical
    to the single-process pipeline."""
    import subprocess
    import sys
    import textwrap

    rng = np.random.default_rng(17)
    bg = rng.choice(np.array(list("acgt")), 30000)
    seg = "".join(rng.choice(np.array(list("ACGT")), 1500))
    chrom = ("".join(bg[:4000]) + seg + "".join(bg[4000:14000]) + seg
             + "".join(bg[14000:]))
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        f.write(">chrZ\n")
        for i in range(0, len(chrom), 70):
            f.write(chrom[i:i + 70] + "\n")

    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(pathlib_repo_root())!r})
        import os
        os.environ["JAX_PLATFORMS"] = "cpu"
        # exercise the fine-grained unit scheduler: the 30 Kbp
        # chromosome splits into ~3 query-range shards per pair
        os.environ["SEDEF_SHARD_BP"] = "10000"
        import jax
        jax.config.update("jax_platforms", "cpu")
        from sedef_tpu.parallel.distributed import (init_distributed,
                                                    run_pipeline_distributed)
        from sedef_tpu.ops.wavefront import WavefrontAligner
        pid = int(sys.argv[1])
        init_distributed("localhost:" + sys.argv[2], 2, pid)
        run_pipeline_distributed({str(fa)!r}, {str(tmp_path / 'outd')!r},
                                 nbuckets=2,
                                 aligner=WavefrontAligner(use_device=False))
    """))
    import shutil
    import socket

    def fresh_port():
        sock = socket.socket()
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
        sock.close()
        return port

    # Coordinator init can flake under full-suite load (port race / slow
    # barrier when the host is contended); retry once on a fresh port.
    last_out = ""
    for attempt in range(2):
        shutil.rmtree(tmp_path / "outd", ignore_errors=True)
        port = fresh_port()
        procs = [subprocess.Popen([sys.executable, str(worker), str(i), port],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for i in range(2)]
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out.decode()[-2000:])
        if all(p.returncode == 0 for p in procs):
            break
        last_out = "\n---\n".join(outs)
    else:
        raise AssertionError(f"2-process run failed twice:\n{last_out}")

    from sedef_tpu.models.pipeline import run_pipeline
    from sedef_tpu.ops.wavefront import WavefrontAligner
    single = run_pipeline(str(fa), str(tmp_path / "outs"), nbuckets=2,
                          aligner=WavefrontAligner(use_device=False))
    assert (open(tmp_path / "outd" / "final.bed").read()
            == open(single["final"]).read())


def pathlib_repo_root():
    import pathlib
    return str(pathlib.Path(__file__).resolve().parent.parent)


def test_mesh_aligner_matches_single_device():
    """MeshAligner (align batch sharded over the 8-device mesh under
    shard_map) produces the exact CIGARs of the single-device aligner."""
    import jax
    import numpy as np

    from sedef_tpu.ops.wavefront import WavefrontAligner
    from sedef_tpu.parallel.mesh import MeshAligner

    devs = jax.devices()
    assert len(devs) >= 8
    mesh = jax.make_mesh((8,), ("data",), devices=devs[:8])
    rng = np.random.default_rng(3)
    pairs = []
    for i in range(37):  # odd count: exercises padding
        L = int(rng.integers(100, 400))
        q = rng.integers(0, 4, L).astype(np.int8)
        t = q.copy()
        m = rng.random(L) < 0.1
        t[m] = (t[m] + rng.integers(1, 4, int(m.sum()))) % 4
        pairs.append((q, t[:int(rng.integers(80, L + 1))]))
    mesh_al = MeshAligner(mesh, use_device=False)
    single = WavefrontAligner(use_device=False)
    assert mesh_al.align_batch(pairs) == single.align_batch(pairs)


def test_default_aligner_stays_on_one_device():
    """With several devices visible the default aligner is still the
    single-device one (MeshAligner is opt-in), routed by the backend."""
    from sedef_tpu.ops import cigar
    from sedef_tpu.ops.wavefront import WavefrontAligner
    from sedef_tpu.parallel.mesh import MeshAligner

    assert len(jax.devices()) >= 8
    old, cigar._default_aligner = cigar._default_aligner, None
    try:
        al = cigar.default_aligner()
        assert type(al) is WavefrontAligner
        assert al is cigar.default_aligner()
        assert not al.use_device and not al._cuda
        assert not MeshAligner()._cuda
    finally:
        cigar._default_aligner = old


# the name predates the port of this route from Pallas; kept so the
# test's record stays continuous
def test_mesh_aligner_pallas_interpret_matches_single():
    """The multi-device device route — shard_map(gap_dp_packed) per shard,
    here the plain JAX route on the 8-device CPU mesh — produces the exact
    single-device CIGARs, with every problem taking the device."""
    import jax
    import numpy as np

    from sedef_tpu.ops.wavefront import WavefrontAligner
    from sedef_tpu.parallel.mesh import MeshAligner

    devs = jax.devices()
    assert len(devs) >= 8
    mesh = jax.make_mesh((8,), ("data",), devices=devs[:8])
    rng = np.random.default_rng(9)
    pairs = []
    for _ in range(17):  # odd: shards get unequal shares
        L = int(rng.integers(90, 300))
        q = rng.integers(0, 4, L).astype(np.int8)
        t = q.copy()
        m = rng.random(L) < 0.12
        t[m] = (t[m] + rng.integers(1, 4, int(m.sum()))) % 4
        pairs.append((q, t[:int(rng.integers(80, L + 1))]))
    mesh_al = MeshAligner(mesh, use_device=True)
    mesh_al.DEVICE_BATCH_MIN = 1
    mesh_al.DEVICE_BATCH_MIN_CELLS = 0
    single = WavefrontAligner(use_device=False)
    assert mesh_al.align_batch(pairs) == single.align_batch(pairs)
    assert mesh_al.device_problems == len(pairs)


# the name predates the port of this route from Pallas; kept so the
# test's record stays continuous
def test_multichip_step_pallas_interpret_matches_scan():
    """The sharded step's per-shard gap DPs (shard_map over the device
    route) equal the single-device plain route on the same problems."""
    from sedef_tpu.ops.wavefront import wavefront_cigar_scan

    mesh = make_mesh(8)
    args = example_inputs(mesh)
    step = build_multichip_step(mesh, S_q=128, S_t=128)
    ops, mcols, *_ = step(*args)
    qseq, tgt, ql, tl = (np.asarray(a) for a in args[:4])
    pp, dd, B = ql.shape
    single = np.asarray(wavefront_cigar_scan(
        qseq.reshape(pp * dd * B, -1), tgt.reshape(pp * dd * B, -1),
        ql.reshape(-1), tl.reshape(-1), 128, 128))
    assert np.array_equal(np.asarray(ops).reshape(single.shape), single)
    from sedef_tpu.parallel.mesh import op_counts
    assert np.array_equal(np.asarray(mcols).reshape(-1),
                          np.asarray(op_counts(single, 0)))


def test_distributed_kill_and_resume(tmp_path):
    """2-process run killed after the seeds stage, then resumed: the
    resumed run must skip stage 1 (collective .ok consensus) and the
    final output must be byte-identical to the single-host pipeline."""
    import subprocess
    import sys
    import textwrap

    rng = np.random.default_rng(23)
    bg = rng.choice(np.array(list("acgt")), 30000)
    seg = "".join(rng.choice(np.array(list("ACGT")), 1500))
    chrom = ("".join(bg[:4000]) + seg + "".join(bg[4000:14000]) + seg
             + "".join(bg[14000:]))
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        f.write(">chrK\n")
        for i in range(0, len(chrom), 70):
            f.write(chrom[i:i + 70] + "\n")

    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {pathlib_repo_root()!r})
        import os
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["SEDEF_SHARD_BP"] = "10000"
        import jax
        jax.config.update("jax_platforms", "cpu")
        from sedef_tpu.parallel.distributed import (init_distributed,
                                                    run_pipeline_distributed)
        from sedef_tpu.ops.wavefront import WavefrontAligner
        pid = int(sys.argv[1])
        stop = sys.argv[3] if len(sys.argv) > 3 else None
        init_distributed("localhost:" + sys.argv[2], 2, pid)
        run_pipeline_distributed({str(fa)!r}, {str(tmp_path / 'outd')!r},
                                 nbuckets=2,
                                 aligner=WavefrontAligner(use_device=False),
                                 stop_after=stop)
    """))
    import shutil
    import socket

    def fresh_port():
        sock = socket.socket()
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
        sock.close()
        return port

    def run_phase(stop):
        # coordinator init flakes under full-suite CPU contention
        # (port race / slow barrier): retry on fresh ports
        outs = []
        for attempt in range(3):
            port = fresh_port()
            procs = [subprocess.Popen(
                [sys.executable, str(worker), str(i), port]
                + ([stop] if stop else []),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for i in range(2)]
            outs = []
            for p in procs:
                out, _ = p.communicate(timeout=600)
                outs.append(out.decode()[-2000:])
            if all(p.returncode == 0 for p in procs):
                return
        raise AssertionError("phase failed 3x:\n" + "\n---\n".join(outs))

    shutil.rmtree(tmp_path / "outd", ignore_errors=True)
    run_phase("seeds")          # "killed" after stage 1
    outd = tmp_path / "outd"
    assert (outd / "seeds.bed").exists() and (outd / "seeds.ok").exists()
    assert not (outd / "final.bed").exists()
    seeds_before = open(outd / "seeds.bed").read()
    # the planted pair MUST seed: an empty stage 1 here would cascade
    # into a "legitimately empty" final.bed downstream — fail loudly at
    # the stage that actually broke (r4 incident forensics)
    assert seeds_before.strip(), "stage 1 produced no seeds"
    run_phase(None)             # resume: must skip stage 1
    assert open(outd / "seeds.bed").read() == seeds_before

    from sedef_tpu.models.pipeline import run_pipeline
    from sedef_tpu.ops.wavefront import WavefrontAligner
    single = run_pipeline(str(fa), str(tmp_path / "outs"), nbuckets=2,
                          aligner=WavefrontAligner(use_device=False))
    assert (open(outd / "final.bed").read()
            == open(single["final"]).read())
    assert (open(outd / "seeds.bed").read()
            == open(single["seeds"]).read())


def test_cli_distributed_two_processes(tmp_path):
    """The CLI pod-slice flags (--coordinator/--num-processes/
    --process-id) drive run_pipeline_distributed; final.bed must match
    the single-process CLI run."""
    import os
    import socket
    import subprocess
    import sys

    rng = np.random.default_rng(31)
    bg = rng.choice(np.array(list("acgt")), 24000)
    seg = "".join(rng.choice(np.array(list("ACGT")), 1500))
    chrom = ("".join(bg[:4000]) + seg + "".join(bg[4000:12000]) + seg
             + "".join(bg[12000:]))
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        f.write(">chrC\n")
        for i in range(0, len(chrom), 70):
            f.write(chrom[i:i + 70] + "\n")

    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": pathlib_repo_root()}

    def fresh_port():
        sock = socket.socket()
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
        sock.close()
        return port

    for attempt in range(3):
        port = fresh_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "sedef_tpu.cli", "pipeline", str(fa),
             "-o", str(tmp_path / "outd"), "-n", "2",
             "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
            for i in range(2)]
        outs = [p.communicate(timeout=600)[0].decode()[-2000:]
                for p in procs]
        if all(p.returncode == 0 for p in procs):
            break
        import shutil
        shutil.rmtree(tmp_path / "outd", ignore_errors=True)
    else:
        raise AssertionError("CLI 2-process run failed 3x:\n"
                             + "\n---\n".join(outs))

    single = subprocess.run(
        [sys.executable, "-m", "sedef_tpu.cli", "pipeline", str(fa),
         "-o", str(tmp_path / "outs"), "-n", "2"],
        capture_output=True, env=env)
    assert single.returncode == 0, single.stderr[-1500:]
    assert (open(tmp_path / "outd" / "final.bed").read()
            == open(tmp_path / "outs" / "final.bed").read())
    assert len(open(tmp_path / "outd" / "final.bed").read()
               .splitlines()) >= 2
