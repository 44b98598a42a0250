"""Batched MinHash-sketch Jaccard scoring on device.

The device formulation of the sliding-Jaccard statistic (SURVEY §7.1):
instead of rolling an incremental ordered map one position at a time
(sliding.cc), score MANY candidate window compositions at once as a
union-rank reduction over sorted key arrays.

Semantics note: this computes the IDEAL sketch intersection — the number
of keys present in both sets among the |Q| smallest of the union.  The
reference's incremental structure drifts from that ideal through its
boundary-add quirk (a ref bit landing exactly on the boundary element is
not counted, sliding.cc:86), making its value path-dependent on insertion
order — and that drift is one-sided (missed increments only), so the
ideal bounds the reference's counter from above.  This is the core
reduction of the PRODUCTION stage-1 roll prefilter
(ops/prefilter.py::_composition_ideals): intervals whose maximum ideal
over all window compositions is below the relaxed Jaccard cutoff are
proven to fail the gate and never rolled on host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# int32 keys: JAX runs without x64, and packed (status, hash) keys fit in
# 2k+2 <= 31 bits for k <= 14 (the device-path constraint)
INF = np.int32(2 ** 31 - 1)


def merge_rank_intersection(q_keys: jax.Array, r_keys: jax.Array,
                            q_size: jax.Array) -> jax.Array:
    """Core union-rank reduction: tagged concat-sort, NO per-element
    binary searches.

    A vmapped ``searchsorted`` membership probe lowers to per-element
    gather chains, so instead each row's query and ref keys
    are tagged into one array (``key*2 + side``; query side sorts first
    for equal keys), sorted once, and scanned with vector compares and a
    cumulative sum:

    * a DISTINCT union element starts wherever ``key`` changes
      (``new_key``); its 0-based distinct rank is ``cumsum(new_key)-1``;
    * a SHARED key is a query-side element immediately followed by the
      same key (the only query occurrence sorts before the ref copies),
      counted iff its rank is below ``q_size`` (sketch boundary,
      inclusive).

    q_keys rows must be sorted and DISTINCT (INF-padded); r_keys rows
    sorted, INF-padded, duplicates allowed (they collapse via new_key).
    Tag headroom: packed (status, hash) keys use 2k+2 <= 30 bits for
    k <= 14, so key*2+1 < 2^31 never wraps and INF (2^31-1) stays the
    largest value.
    """
    B = q_keys.shape[0]
    aq = jnp.where(q_keys == INF, INF, q_keys * 2)
    ar = jnp.where(r_keys == INF, INF, r_keys * 2 + 1)
    arr = jnp.sort(jnp.concatenate([aq, ar], axis=1), axis=1)
    key = arr >> 1
    prev = jnp.concatenate(
        [jnp.full((B, 1), -1, jnp.int32), key[:, :-1]], axis=1)
    new_key = (key != prev) & (arr != INF)
    rank = jnp.cumsum(new_key.astype(jnp.int32), axis=1) - 1
    nxt = jnp.concatenate(
        [key[:, 1:], jnp.full((B, 1), -2, jnp.int32)], axis=1)
    shared = new_key & ((arr & 1) == 0) & (nxt == key)
    return ((shared & (rank < q_size[:, None]))
            .sum(axis=1).astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=())
def sketch_intersection(q_keys: jax.Array, r_keys: jax.Array,
                        q_size: jax.Array) -> jax.Array:
    """Ideal sketch intersections, batched.

    q_keys: (B, S) sorted distinct query keys (int32), padded with INF
    r_keys: (B, M) sorted ref keys (HAS_N excluded), INF-padded;
        duplicates allowed — they collapse inside the union-rank
        reduction via its ``new_key`` distinct-element detection
    q_size: (B,) true |Q| per row
    Returns (B,) int32: |{k in Q ∩ R : rank_union(k) < |Q|}| — the count of
    shared keys inside the |Q|-smallest union window (boundary inclusive).
    """
    return merge_rank_intersection(q_keys, r_keys, q_size)


def windows_to_arrays(window_key_sets: list[np.ndarray], pad_to: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-size sorted key sets into an INF-padded matrix."""
    B = len(window_key_sets)
    out = np.full((B, pad_to), INF, dtype=np.int32)
    sizes = np.zeros(B, dtype=np.int32)
    for i, ks in enumerate(window_key_sets):
        k = np.unique(ks)
        k = k[: pad_to]
        out[i, : len(k)] = k
        sizes[i] = len(k)
    return out, sizes
