"""Batched device roll engine: stage-1 sliding-Jaccard scans on device.

The reference's hottest loop (``src/search.cc:289-315``) rolls a ~700 bp
reference window one base at a time over each candidate interval,
maintaining an incremental ordered-map MinHash sketch
(``src/sliding.cc``) whose intersection counter is *path-dependent*
(a ref bit landing exactly on the boundary element is not counted —
sliding.cc:86) — so the value cannot be recomputed from window content;
the op stream itself must be replayed.  This module replays thousands of
those op streams in parallel on device:

* the sketch is one sorted int32 row per interval — ``key << 2 | flags``
  (query=1, ref=2; a real key needs 2k+2 <= 28 bits, so the packed store
  requires k <= 13; the reference default is k = 12) — padded with INF,
* insert/delete are masked vector shifts; the boundary index, the
  intersection counter and all four quirk branches of ``SlidingJaccard``
  (ops/sliding.py) are reproduced literally, per lane,
* each roll step applies at most one conditional ref-remove and one
  conditional ref-add (minimizer loci are strictly increasing), exactly
  like the scalar loop,
* outputs per interval: the best (earliest, strictly-improving) signed
  jaccard and its step count — the host engine replays only the winner's
  prefix for surviving intervals and skips failed intervals entirely.

An interval's op stream is fully determined by (query window, t_start,
t_end, reference index), so results are exact whenever the production
pass encounters the same interval tuple; windows whose candidate set was
altered by hit-tree dedup fall back to the host roll (see
models/seeder.py / native sedef_search).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INF32 = np.int32(2**31 - 1)

# size classes: (T_PAD ladder) x fixed INIT_PAD / SQ / W keeps the jit
# cache small; intervals beyond the largest class use the host roll.
# The ladder is deliberately coarse: every (T_PAD, input-shape) pair is a
# distinct XLA compile, and padded steps are masked vector ops — wasting
# some lanes is cheaper than another compile variant.
DEFAULT_W = 512
DEFAULT_SQ = 160
DEFAULT_INIT_PAD = 192
T_PAD_LADDER = (512, 4096)
DEFAULT_BATCH = 1024


def _take1(a, idx):
    """a[b, idx[b]] for every lane b."""
    return jnp.take_along_axis(a, idx[:, None], axis=1)[:, 0]


def _vadd(st, h, bit, do):
    """SlidingJaccard._add(h, bit) (ops/sliding.py:67-86), vectorized.

    st = (store, ln, Bp, inter, ovf); h (B,) int32 keys; do (B,) bool.
    """
    store, ln, Bp, inter, ovf = st
    B, W = store.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    hs = h[:, None]

    pos = jnp.sum((store >> 2) < hs, axis=1).astype(jnp.int32)
    cur = _take1(store, jnp.minimum(pos, W - 1))
    exists = ((cur >> 2) == h) & (pos < W)
    flag_h = jnp.where(exists, cur & 3, 0)
    already = exists & ((flag_h & bit) != 0)
    eff = do & ~already
    ins = eff & ~exists
    full = ins & (ln >= W)
    ovf = ovf | full
    ins = ins & ~full
    eff = eff & ~full

    posb = pos[:, None]
    # existing element: flags |= bit
    store = jnp.where((eff & exists)[:, None] & (idx == posb),
                      store | bit, store)
    # insertion: shift right at pos
    shift_r = jnp.concatenate([store[:, :1], store[:, :-1]], axis=1)
    inserted = jnp.where(idx < posb, store,
                         jnp.where(idx == posb, (hs << 2) | bit, shift_r))
    store = jnp.where(ins[:, None], inserted, store)
    ln = ln + ins
    # keep B pointing at the same element (sliding.py:79-80)
    Bp = Bp + (ins & (pos <= Bp))

    # boundary branch (sliding.py:81-85): state AFTER the insert
    bcur = _take1(store, jnp.minimum(Bp, W - 1))
    cond = eff & (h < (bcur >> 2))  # query_size > 0 always in roll use
    new_flag = jnp.where(exists, flag_h | bit, bit)
    inter = inter + jnp.where(cond & (new_flag == 3), 1, 0)
    dec = cond & ins
    inter = inter - jnp.where(dec & ((bcur & 3) == 3), 1, 0)
    Bp = Bp - dec
    return (store, ln, Bp, inter, ovf)


def _vremove(st, h, bit, do):
    """SlidingJaccard._remove(h, bit) (ops/sliding.py:88-109), vectorized."""
    store, ln, Bp, inter, ovf = st
    B, W = store.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    hs = h[:, None]

    pos = jnp.sum((store >> 2) < hs, axis=1).astype(jnp.int32)
    cur = _take1(store, jnp.minimum(pos, W - 1))
    found = ((cur >> 2) == h) & (pos < W)
    flag_h = jnp.where(found, cur & 3, 0)
    eff = do & found & ((flag_h & bit) != 0)
    erase = eff & (flag_h == bit)

    # boundary branch first (state BEFORE the physical removal)
    bcur = _take1(store, jnp.minimum(Bp, W - 1))
    cond = eff & (h <= (bcur >> 2))
    inter = inter - jnp.where(cond & (flag_h == 3), 1, 0)
    step = cond & erase
    Bp2 = jnp.where(step, Bp + 1, Bp)
    b2 = _take1(store, jnp.minimum(Bp2, W - 1))
    inter = inter + jnp.where(step & (Bp2 < ln) & ((b2 & 3) == 3), 1, 0)
    Bp = Bp2

    # physical erase / flag clear
    posb = pos[:, None]
    shift_l = jnp.concatenate(
        [store[:, 1:], jnp.full((B, 1), INF32, jnp.int32)], axis=1)
    erased = jnp.where(idx < posb, store, shift_l)
    cleared = jnp.where(idx == posb, store & ~bit, store)
    store = jnp.where(erase[:, None], erased,
                      jnp.where((eff & ~erase)[:, None], cleared, store))
    ln = ln - erase
    Bp = Bp - (erase & (pos < Bp))
    return (store, ln, Bp, inter, ovf)


@functools.partial(jax.jit, static_argnames=(
    "W", "SQ", "INIT_PAD", "T_PAD", "n_shift"))
def _roll_batch(r_keys, r_locs, nr, rlen, limit_lut,
                q_keys, qws, qwe, t0, rws0, init_cnt, n_steps, re0,
                W: int, SQ: int, INIT_PAD: int, T_PAD: int, n_shift: int):
    """One batch of interval rolls.  All interval arrays are (B,) int32;
    r_keys/r_locs/q_keys are the device-resident minimizer arrays.

    Returns (best_j, best_steps, ok) — ok False where the sketch exceeded
    its W/SQ capacity (host falls back for those intervals).
    """
    B = qws.shape[0]
    nq = q_keys.shape[0]
    nrr = r_keys.shape[0]

    # ---- initial query-only sketch: sorted distinct window keys,
    # flags=1, B = s-1, intersection = 0 (closed form, seeder.py) ----
    gidx = qws[:, None] + jax.lax.broadcasted_iota(jnp.int32, (1, SQ), 1)
    val = gidx < qwe[:, None]
    qk = jnp.where(val, jnp.take(q_keys, jnp.minimum(gidx, nq - 1)), INF32)
    qk = jnp.sort(qk, axis=1)
    dupm = jnp.concatenate(
        [jnp.zeros((B, 1), bool), qk[:, 1:] == qk[:, :-1]], axis=1)
    qk = jnp.where(dupm | (qk == INF32), INF32, qk)
    qk = jnp.sort(qk, axis=1)
    s = jnp.sum(qk != INF32, axis=1).astype(jnp.int32)
    limit = limit_lut[jnp.minimum(s, limit_lut.shape[0] - 1)]
    ovf0 = (qwe - qws) > SQ

    store = jnp.full((B, W), INF32, jnp.int32)
    store = store.at[:, :SQ].set(
        jnp.where(qk != INF32, (qk << 2) | 1, INF32))
    st = (store, s, s - 1, jnp.zeros((B,), jnp.int32), ovf0)

    def has_n(h):
        return (h >> n_shift) == 2

    # ---- phase A: add_to_reference over the initial window ----
    def init_body(i, st):
        gi = jnp.minimum(rws0 + i, nrr - 1)
        h = jnp.take(r_keys, gi)
        do = (i < init_cnt) & ~has_n(h)
        return _vadd(st, h, 2, do)

    st = jax.lax.fori_loop(0, INIT_PAD, init_body, st)
    ovf_init = init_cnt > INIT_PAD

    def jaccard(st):
        _, _, _, inter, _ = st
        return jnp.where(inter >= limit, inter, inter - limit)

    # ---- phase B: the roll (search.cc:289-315 / native search_interval) --
    def step_body(t, carry):
        st, rws, rwe, rs, re, best_j, best_steps = carry
        active = t < n_steps
        # conditional remove: locs[rws] < rs + 1
        gi = jnp.minimum(rws, nrr - 1)
        loc_r = jnp.take(r_locs, gi)
        h_r = jnp.take(r_keys, gi)
        can_r = active & (rws < nr) & (loc_r < rs + 1)
        st = _vremove(st, h_r, 2, can_r & ~has_n(h_r))
        rws = rws + can_r
        # conditional add: locs[rwe] == re
        ga = jnp.minimum(rwe, nrr - 1)
        loc_a = jnp.take(r_locs, ga)
        h_a = jnp.take(r_keys, ga)
        can_a = active & (rwe < nr) & (loc_a == re)
        st = _vadd(st, h_a, 2, can_a & ~has_n(h_a))
        rwe = rwe + can_a
        # strict improvement, earliest wins
        j = jaccard(st)
        upd = active & (j > best_j)
        best_j = jnp.where(upd, j, best_j)
        best_steps = jnp.where(upd, t + 1, best_steps)
        rs = rs + active
        re = re + active
        return (st, rws, rwe, rs, re, best_j, best_steps)

    best_j0 = jaccard(st)
    carry = (st, rws0, rws0 + init_cnt, t0, re0, best_j0,
             jnp.zeros((B,), jnp.int32))
    carry = jax.lax.fori_loop(0, T_PAD, step_body, carry)
    st, _, _, _, _, best_j, best_steps = carry
    _, _, _, _, ovf = st
    ok = ~(ovf | ovf_init | (n_steps > T_PAD))
    return best_j, best_steps, ok


def _t_class(n: int) -> int:
    for t in T_PAD_LADDER:
        if n <= t:
            return t
    return 0  # too large -> host


# NOTE: exact replay costs O(W) vector lanes per roll step against the
# scalar engine's amortized O(1) ordered-map ops, so the device advantage
# is bounded by batch width; ROLL_DEVICE_MIN gates it (its rate on a GPU
# is not measured, ROADMAP S5).


class RollEngine:
    """Batches planned intervals by roll-length class and runs them on
    device.  ``run`` takes the plan arrays (see native sedef_search_plan)
    plus device-resident minimizer key/loc arrays and returns per-interval
    (best_j, best_steps, ok) in plan order."""

    def __init__(self, kmer_size: int, limit_lut: np.ndarray,
                 W: int = DEFAULT_W, SQ: int = DEFAULT_SQ,
                 INIT_PAD: int = DEFAULT_INIT_PAD,
                 batch: int = DEFAULT_BATCH):
        if kmer_size > 13:
            raise ValueError("packed store needs 2k+4 <= 32 bits (k <= 13)")
        self.n_shift = 2 * kmer_size
        self.limit_lut = jnp.asarray(limit_lut.astype(np.int32))
        self.W, self.SQ, self.INIT_PAD = W, SQ, INIT_PAD
        self.batch = batch

    def run(self, q_keys_dev, r_keys_dev, r_locs_dev, nr: int, rlen: int,
            qws, qwe, t0, rws0, init_cnt, n_steps, re0):
        n = len(qws)
        best_j = np.zeros(n, np.int32)
        best_steps = np.zeros(n, np.int32)
        ok = np.zeros(n, bool)
        if n == 0:
            return best_j, best_steps, ok
        tclass = np.array([_t_class(int(x)) for x in n_steps], np.int32)
        pending = []  # dispatch everything async, sync once at the end
        for T in sorted(set(tclass.tolist())):
            if T == 0:
                continue  # host fallback
            sel = np.nonzero(tclass == T)[0]
            for off in range(0, len(sel), self.batch):
                part = sel[off:off + self.batch]
                m = len(part)
                pad = self.batch - m

                def pk(a):
                    v = np.asarray(a, np.int32)[part]
                    if pad:
                        v = np.concatenate([v, np.zeros(pad, np.int32)])
                    return v

                ns = pk(n_steps)
                if pad:
                    ns[m:] = 0  # dummies: 0 steps
                out = _roll_batch(
                    r_keys_dev, r_locs_dev,
                    np.int32(nr), np.int32(rlen), self.limit_lut,
                    q_keys_dev,
                    pk(qws), pk(qwe), pk(t0), pk(rws0), pk(init_cnt),
                    ns, pk(re0),
                    W=self.W, SQ=self.SQ, INIT_PAD=self.INIT_PAD,
                    T_PAD=T, n_shift=self.n_shift)
                pending.append((part, m, out))
        for part, m, (bj, bs, okk) in pending:
            best_j[part] = np.asarray(bj)[:m]
            best_steps[part] = np.asarray(bs)[:m]
            ok[part] = np.asarray(okk)[:m]
        return best_j, best_steps, ok
