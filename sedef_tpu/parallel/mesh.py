"""Multi-chip device-mesh execution of the batched compute step.

The reference scales by fanning ~n(n+1) independent chromosome-pair
processes over cores via GNU Parallel with the filesystem as the collective
(SURVEY §2.2 P1/C1; ``sedef.sh:133-140``).  The device equivalent:

* a 2-D ``jax.sharding.Mesh`` with axes ("pairs", "data") — chromosome-pair
  jobs shard over "pairs", each job's batched windows/DP problems shard
  over "data";
* the per-step compute (q-gram filter scoring + wavefront DP) runs under
  ``shard_map`` with XLA collectives: ``psum`` for the global funnel
  counters (the reference's TOTAL/JACCARD/... tallies, search.cc:29-31)
  and an ``all_gather`` for per-shard hit counts;
* hosts exchange candidate-hit tensors only at stage barriers, which
  single-host deployments never hit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..device import accelerator
from ..ops.filter import QG, QSZ
from ..ops.wavefront import (WavefrontAligner, cigar_from_packed_ops,
                             class_parts, gap_dp_packed, pack_class_batch)


def make_mesh(n_devices: int | None = None) -> Mesh:
    """2-D mesh over available devices: ("pairs", "data")."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    # squarest 2-D factorization
    p = int(np.floor(np.sqrt(n_devices)))
    while n_devices % p:
        p -= 1
    return jax.make_mesh((p, n_devices // p), ("pairs", "data"),
                         devices=devs)


def qgram_scores(codes_a: jax.Array, codes_b: jax.Array) -> jax.Array:
    """Batched shared-q-gram counts: (..., W) uint8 code windows ->
    (...,) int32 shared 5-gram histogram intersection (filter.cc:55-91
    as a segment-sum over 1024 bins)."""
    W = codes_a.shape[-1]
    n = W - QG + 1

    def grams(c):
        g = jnp.zeros(c.shape[:-1] + (n,), jnp.int32)
        for j in range(QG):
            g = (g << 2) | jax.lax.dynamic_slice_in_dim(
                c.astype(jnp.int32), j, n, axis=-1)
        return g

    ga = grams(codes_a)
    gb = grams(codes_b)

    def hist(g):
        lead = g.shape[:-1]
        flat = g.reshape(-1, g.shape[-1])
        h = jax.vmap(lambda x: jnp.zeros(QSZ, jnp.int32).at[x].add(1))(flat)
        return h.reshape(lead + (QSZ,))

    return jnp.minimum(hist(ga), hist(gb)).sum(axis=-1)


def op_counts(ops: jax.Array, op: int) -> jax.Array:
    """Per-problem count of ``op`` codes in a packed op stream (B, n)."""
    o = ops.astype(jnp.int32)
    return sum((((o >> (2 * k)) & 3) == op).sum(axis=-1)
               for k in range(4)).astype(jnp.int32)


def build_multichip_step(mesh: Mesh, S_q: int, S_t: int):
    """The full sharded compute step: q-gram gate -> gap DP (the device
    route, ``gap_dp_packed``) -> collective funnel reduction.  Inputs are
    globally shaped (P_pairs, D_data, B, ...) and sharded over the first
    two axes."""
    cuda = accelerator() is not None

    def local_step(qseq, tgt, ql, tl, win_a, win_b, minqg):
        # (1, 1, B, ...) local shard; squeeze the mesh dims
        qseq, tgt, ql, tl, win_a, win_b = (
            a.reshape(a.shape[2:]) for a in (qseq, tgt, ql, tl, win_a,
                                             win_b))
        qg = qgram_scores(win_a, win_b)                  # (B,)
        passed = qg >= minqg.reshape(())
        ops = gap_dp_packed(qseq, tgt, ql, tl, S_q, S_t, cuda=cuda)
        # per-problem proxy statistic: matched columns of the alignment
        mcols = op_counts(ops, 0)

        # global funnel counters over the whole mesh
        total = jax.lax.psum(jnp.int32(qg.shape[0]), ("pairs", "data"))
        total_passed = jax.lax.psum(passed.sum().astype(jnp.int32),
                                    ("pairs", "data"))
        # per-shard hit counts gathered along the data axis
        counts = jax.lax.all_gather(passed.sum().astype(jnp.int32),
                                    "data")
        return (ops[None, None], mcols[None, None], qg[None, None],
                total, total_passed, counts[None])

    shard = P("pairs", "data")
    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(shard,) * 6 + (P(),),
        out_specs=(shard, shard, shard, P(), P(), P("pairs", None)),
        check_vma=False)
    return jax.jit(step)


class MeshAligner(WavefrontAligner):
    """Align-stage aligner that shards each device batch across ALL local
    devices of a 1-D ("data") mesh under ``shard_map`` — the multi-device
    replacement for the reference's per-process fan-out
    (sedef.sh:187-190): problems are independent, so the batch axis shards
    with no collectives and wall time scales with the device count.

    Routing (host vs device, size classes) is the single-device
    ``WavefrontAligner``'s; each shard runs the device route
    (``gap_dp_packed``: the CUDA kernel on GPU meshes, plain JAX on CPU
    meshes).  Results are identical to the single-device aligner: batch
    composition does not affect per-problem DP results.
    """

    def __init__(self, mesh: Mesh | None = None, cfg=None,
                 use_device: bool | None = None):
        from ..config import DEFAULT
        super().__init__(cfg or DEFAULT, use_device=use_device)
        if mesh is None:
            devs = jax.devices()
            mesh = jax.make_mesh((len(devs),), ("data",), devices=devs)
        self.mesh = mesh
        self.ndev = int(mesh.devices.size)
        self._fns: dict[tuple[int, int], object] = {}

    def _sharded(self, S_q: int, S_t: int):
        key = (S_q, S_t)
        if key not in self._fns:
            fn = functools.partial(
                gap_dp_packed, S_q=S_q, S_t=S_t, match=self.match,
                mis=self.mis, gapo=self.gapo, gape=self.gape,
                cuda=self._cuda)
            self._fns[key] = jax.jit(jax.shard_map(
                fn, mesh=self.mesh, in_specs=(P("data"),) * 4,
                out_specs=P("data"), check_vma=False))
        return self._fns[key]

    def _align_device(self, pairs, idxs, results) -> None:
        if self.ndev <= 1:
            return super()._align_device(pairs, idxs, results)
        shard = NamedSharding(self.mesh, P("data"))
        for (S_q, S_t), cls_idx in self.device_groups(pairs, idxs).items():
            for part in class_parts(cls_idx, S_q, S_t, self._cuda,
                                    self.ndev):
                # problem k -> row (k % ndev) * per + k // ndev: every
                # shard gets an equal share of the real problems
                per = 1 << max(3, (-(-len(part) // self.ndev) - 1)
                               .bit_length())
                order: list[int | None] = [None] * (per * self.ndev)
                rows = [(k % self.ndev) * per + k // self.ndev
                        for k in range(len(part))]
                for k, row in enumerate(rows):
                    order[row] = part[k]
                arrs = pack_class_batch(pairs, order, S_q, S_t, len(order))
                ops = np.asarray(self._sharded(S_q, S_t)(
                    *(jax.device_put(a, shard) for a in arrs)))
                for row, idx in zip(rows, part):
                    qc, tc = pairs[idx]
                    results[idx] = cigar_from_packed_ops(ops[row], len(qc),
                                                         len(tc))
            self.count_device(pairs, cls_idx)


def example_inputs(mesh: Mesh, S_q: int = 128, S_t: int = 128, B: int = 2,
                   W: int = 128, seed: int = 0):
    """Tiny sharded inputs for one step on the given mesh: B gap-DP
    problems of class (S_q, S_t) and B q-gram window pairs per shard."""
    pp, dd = mesh.devices.shape
    rng = np.random.default_rng(seed)
    qseq = rng.integers(0, 4, (pp, dd, B, S_q)).astype(np.int8)
    tgt = rng.integers(0, 4, (pp, dd, B, S_t)).astype(np.int8)
    ql = rng.integers(S_q // 2, S_q + 1, (pp, dd, B)).astype(np.int32)
    tl = rng.integers(S_t // 2, S_t + 1, (pp, dd, B)).astype(np.int32)
    win_a = rng.integers(0, 4, (pp, dd, B, W)).astype(np.uint8)
    win_b = win_a.copy()
    flip = rng.random(win_b.shape) < 0.1
    win_b[flip] = rng.integers(0, 4, int(flip.sum()))
    shard = NamedSharding(mesh, P("pairs", "data"))
    return tuple(jax.device_put(a, shard)
                 for a in (qseq, tgt, ql, tl, win_a, win_b)) + (
        jnp.int32(10),)
