"""Vectorized stackless BVH traversal over the ray wavefront (pure jnp).

Every ray in the batch walks the skip-link tree in lockstep:

    next = (aabb_hit & inner) ? node + 1 : miss[node]

One `lax.while_loop` iterates until all lanes run off the end (node == N).
Each step costs two gathers (node box + meta) and, when a lane sits on a
leaf, up to `max_leaf` unrolled Moller-Trumbore tests against contiguous
reordered triangles. Finished lanes idle on node N-1 with masked updates.

This replaces the reference's per-thread stack traversal
(src/GoblinBVH.cpp:156-280) with uniform control flow. It is the plain
reference for the GPU kernel ops/trace_kernel, which walks the same tree
in the same order one ray per lane, and the trace off the GPU.
Rays with maxt <= mint start finished.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry.intersect import BIG_T, moller_trumbore

from typing import NamedTuple


class TraceResult(NamedTuple):
    hit: jnp.ndarray  # (R,) bool
    t: jnp.ndarray  # (R,) f32 (BIG_T where miss)
    tri: jnp.ndarray  # (R,) i32 triangle id in *reordered* soup order
    b1: jnp.ndarray  # (R,) f32 barycentric
    b2: jnp.ndarray  # (R,) f32


def _gather_tri(tri_soup, idx):
    """tri_soup: (T, 9) packed v0|e1|e2 -> (..., 3) x3 at idx."""
    rows = jnp.take(tri_soup, idx, axis=0, mode="clip")
    return rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]


@partial(jax.jit, static_argnames=("max_leaf", "any_hit"))
def trace(
    node_bounds,  # (N, 6) f32
    node_meta,  # (N, 3) i32 [first, count, miss]
    tri_soup,  # (T, 9) f32 packed v0|e1|e2 in BVH order
    o,  # (R, 3)
    d,  # (R, 3)
    mint,  # (R,)
    maxt,  # (R,)
    max_leaf: int = 4,
    any_hit: bool = False,
):
    """Closest-hit (or any-hit) trace of a ray batch. Returns TraceResult.

    For any_hit=True the walk terminates per-lane at the first accepted
    hit (t is then *a* hit distance, not the closest).
    """
    N = node_bounds.shape[0]
    R = o.shape[0]
    inv_d = 1.0 / jnp.where(d == 0.0, 1e-30, d)

    init = (
        jnp.where(maxt > mint, 0, N).astype(jnp.int32),  # node
        jnp.where(maxt < BIG_T, maxt, BIG_T),  # best t (doubles as cur maxt)
        jnp.full((R,), -1, jnp.int32),  # best tri
        jnp.zeros((R,), jnp.float32),  # b1
        jnp.zeros((R,), jnp.float32),  # b2
    )

    def cond(state):
        node = state[0]
        return jnp.any(node < N)

    def body(state):
        node, t_best, tri_best, b1_best, b2_best = state
        live = node < N
        nidx = jnp.minimum(node, N - 1)
        box = jnp.take(node_bounds, nidx, axis=0)
        meta = jnp.take(node_meta, nidx, axis=0)
        first, count, miss = meta[:, 0], meta[:, 1], meta[:, 2]

        # slab test against current best-t
        t0 = (box[:, 0:3] - o) * inv_d
        t1 = (box[:, 3:6] - o) * inv_d
        tn = jnp.maximum(jnp.max(jnp.minimum(t0, t1), axis=-1), mint)
        tf = jnp.minimum(jnp.min(jnp.maximum(t0, t1), axis=-1), t_best)
        box_hit = (tn <= tf) & live

        is_leaf = count > 0
        do_leaf = box_hit & is_leaf

        # unrolled leaf triangle tests (contiguous tris: first..first+count)
        for k in range(max_leaf):
            tri_id = first + k
            v0, e1, e2 = _gather_tri(tri_soup, tri_id)
            h, t, b1, b2 = moller_trumbore(o, d, v0, e1, e2, mint, t_best)
            upd = do_leaf & (k < count) & h
            t_best = jnp.where(upd, t, t_best)
            tri_best = jnp.where(upd, tri_id, tri_best)
            b1_best = jnp.where(upd, b1, b1_best)
            b2_best = jnp.where(upd, b2, b2_best)

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, node + 1, miss)
        if any_hit:
            nxt = jnp.where(tri_best >= 0, N, nxt)
        node = jnp.where(live, nxt, node)
        return node, t_best, tri_best, b1_best, b2_best

    _, t_best, tri_best, b1, b2 = jax.lax.while_loop(cond, body, init)
    hit = tri_best >= 0
    return TraceResult(hit, jnp.where(hit, t_best, BIG_T), tri_best, b1, b2)


def occluded(node_bounds, node_meta, tri_soup, o, d, mint, maxt, max_leaf=4):
    """Any-hit visibility query: True where the segment is blocked."""
    res = trace(
        node_bounds, node_meta, tri_soup, o, d, mint, maxt,
        max_leaf=max_leaf, any_hit=True,
    )
    return res.hit


def pack_tri_soup(v0, v1, v2):
    """(T,3) x3 vertices -> (T, 9) packed v0|e1|e2 rows."""
    return jnp.concatenate([v0, v1 - v0, v2 - v0], axis=-1)
