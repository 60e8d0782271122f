"""BVH trace kernel for NVIDIA GPUs (Pallas, Triton route).

The same skip-link walk as the reference traversal `accel.traverse.trace`,
written for one ray per lane:

    next = (aabb_hit & inner) ? node + 1 : miss[node]

A program owns BLOCK rays and loops until *its* rays are done, so a block
of short rays retires early instead of waiting for the slowest ray of the
whole wavefront. Node and triangle rows are gathered per lane straight from
device memory (the tables of a bunny-class scene stay L2-resident); every
load is masked, so finished lanes and inner-node steps fetch no triangles.
Rays with maxt <= mint never enter the loop.

Tables are padded to power-of-two row widths so each row is one aligned
load of 32 bytes (node box), 16 bytes (node meta) or 64 bytes (triangle).
The visit order and the arithmetic match `accel.traverse.trace`, so results
agree with it up to float contraction (FMA) differences in the
Moller-Trumbore test.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..accel.traverse import TraceResult
from ..geometry.intersect import BIG_T, TRI_EPS

# rays per program, one per lane, and warps per program: the best or
# near-best pair for bunny wavefronts in a sweep over 64/128/256 rays and
# 1-8 warps on an H100 (PERF.md)
BLOCK = 128
NUM_WARPS = 4
NODE_W = 8  # [bmin.xyz, bmax.xyz, pad, pad]
META_W = 4  # [first, count, miss, pad]
TRI_W = 16  # [v0.xyz, e1.xyz, e2.xyz, pad x7]


def pack_tables(node_bounds, node_meta, tri_soup):
    """Pad the BVH and triangle tables to the kernel's row widths."""
    nodes = jnp.pad(node_bounds, ((0, 0), (0, NODE_W - 6)))
    meta = jnp.pad(node_meta, ((0, 0), (0, META_W - 3)))
    tris = jnp.pad(tri_soup, ((0, 0), (0, TRI_W - 9)))
    return nodes, meta, tris


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _moller_trumbore(o, d, v0, e1, e2, mint, maxt):
    """Component-wise twin of geometry.intersect.moller_trumbore."""
    s1 = _cross(d, e2)
    divisor = _dot(s1, e1)
    inv = 1.0 / jnp.where(divisor == 0.0, 1e-30, divisor)
    s = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    b1 = _dot(s, s1) * inv
    s2 = _cross(s, e1)
    b2 = _dot(d, s2) * inv
    t = _dot(e2, s2) * inv
    hit = (
        (divisor != 0.0)
        & (b1 + TRI_EPS >= 0.0)
        & (b1 - TRI_EPS <= 1.0)
        & (b2 + TRI_EPS >= 0.0)
        & (b1 + b2 - TRI_EPS <= 1.0)
        & (t >= mint)
        & (t <= maxt)
    )
    return hit, t, b1, b2


def _trace_kernel(nodes_ref, meta_ref, tris_ref, rays_ref,
                  t_ref, tri_ref, b1_ref, b2_ref, *, n_nodes, max_leaf,
                  any_hit):
    ox, oy, oz, dx, dy, dz, mint, maxt = (rays_ref[c] for c in range(8))
    o = (ox, oy, oz)
    d = (dx, dy, dz)
    inv_d = tuple(1.0 / jnp.where(c == 0.0, 1e-30, c) for c in d)

    def gather(ref, row, col, mask, other):
        return plgpu.load(ref.at[jnp.where(mask, row, 0), col],
                          mask=mask, other=other)

    def cond(state):
        return jnp.min(state[0]) < n_nodes

    def body(state):
        node, t_best, tri_best, b1_best, b2_best = state
        live = node < n_nodes
        lo = [gather(nodes_ref, node, c, live, 0.0) for c in range(3)]
        hi = [gather(nodes_ref, node, 3 + c, live, 0.0) for c in range(3)]
        first = gather(meta_ref, node, 0, live, 0)
        count = gather(meta_ref, node, 1, live, 0)
        miss = gather(meta_ref, node, 2, live, n_nodes)

        t0 = [(lo[c] - o[c]) * inv_d[c] for c in range(3)]
        t1 = [(hi[c] - o[c]) * inv_d[c] for c in range(3)]
        near = [jnp.minimum(a, b) for a, b in zip(t0, t1)]
        far = [jnp.maximum(a, b) for a, b in zip(t0, t1)]
        tn = jnp.maximum(jnp.maximum(jnp.maximum(near[0], near[1]), near[2]),
                         mint)
        tf = jnp.minimum(jnp.minimum(jnp.minimum(far[0], far[1]), far[2]),
                         t_best)
        box_hit = (tn <= tf) & live
        is_leaf = count > 0
        do_leaf = box_hit & is_leaf

        for k in range(max_leaf):
            tid = first + k
            test = do_leaf & (k < count)
            row = [gather(tris_ref, tid, c, test, 0.0) for c in range(9)]
            h, t, b1, b2 = _moller_trumbore(
                o, d, row[0:3], row[3:6], row[6:9], mint, t_best
            )
            upd = test & h
            t_best = jnp.where(upd, t, t_best)
            tri_best = jnp.where(upd, tid, tri_best)
            b1_best = jnp.where(upd, b1, b1_best)
            b2_best = jnp.where(upd, b2, b2_best)

        nxt = jnp.where(box_hit & ~is_leaf, node + 1, miss)
        if any_hit:
            nxt = jnp.where(tri_best >= 0, n_nodes, nxt)
        node = jnp.where(live, nxt, node)
        return node, t_best, tri_best, b1_best, b2_best

    init = (
        jnp.where(maxt > mint, 0, n_nodes).astype(jnp.int32),
        jnp.where(maxt < BIG_T, maxt, BIG_T),
        jnp.full(maxt.shape, -1, jnp.int32),
        jnp.zeros(maxt.shape, jnp.float32),
        jnp.zeros(maxt.shape, jnp.float32),
    )
    _, t_best, tri_best, b1, b2 = jax.lax.while_loop(cond, body, init)
    t_ref[...] = jnp.where(tri_best >= 0, t_best, BIG_T)
    tri_ref[...] = tri_best
    b1_ref[...] = b1
    b2_ref[...] = b2


def trace(node_bounds, node_meta, tri_soup, o, d, mint, maxt,
          max_leaf: int = 4, any_hit: bool = False, interpret: bool = False):
    """Kernel twin of `accel.traverse.trace`: same arguments, same
    TraceResult. interpret=True runs the kernel through the Pallas
    interpreter on any backend (the CPU tests use it); without it the
    kernel compiles for the GPU only, and any other backend raises."""
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the BVH trace kernel compiles for GPUs only; backend is "
            f"{jax.default_backend()!r} (pass interpret=True to run it "
            "in the Pallas interpreter)"
        )
    return _trace(node_bounds, node_meta, tri_soup, o, d, mint, maxt,
                  max_leaf=max_leaf, any_hit=any_hit, interpret=interpret)


@partial(jax.jit, static_argnames=("max_leaf", "any_hit", "interpret"))
def _trace(node_bounds, node_meta, tri_soup, o, d, mint, maxt, max_leaf,
           any_hit, interpret):
    R = o.shape[0]
    pad = (-R) % BLOCK
    rays = jnp.concatenate(
        [o.T, d.T, mint[None], maxt[None]], axis=0
    ).astype(jnp.float32)
    if pad:
        # padding lanes are dead (mint > maxt) and never enter the loop
        dead = jnp.zeros((8, pad), jnp.float32).at[6].set(BIG_T)
        rays = jnp.concatenate([rays, dead], axis=1)
    Rp = R + pad
    nodes, meta, tris = pack_tables(node_bounds, node_meta, tri_soup)
    kernel = partial(
        _trace_kernel, n_nodes=node_bounds.shape[0], max_leaf=max_leaf,
        any_hit=any_hit,
    )
    lane = pl.BlockSpec((BLOCK,), lambda i: (i,))
    t, tri, b1, b2 = pl.pallas_call(
        kernel,
        grid=(Rp // BLOCK,),
        in_specs=[
            pl.BlockSpec(nodes.shape, lambda i: (0, 0)),
            pl.BlockSpec(meta.shape, lambda i: (0, 0)),
            pl.BlockSpec(tris.shape, lambda i: (0, 0)),
            pl.BlockSpec((8, BLOCK), lambda i: (0, i)),
        ],
        out_specs=[lane, lane, lane, lane],
        out_shape=[
            jax.ShapeDtypeStruct((Rp,), jnp.float32),
            jax.ShapeDtypeStruct((Rp,), jnp.int32),
            jax.ShapeDtypeStruct((Rp,), jnp.float32),
            jax.ShapeDtypeStruct((Rp,), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_trace",
    )(nodes, meta, tris, rays)
    t, tri, b1, b2 = (v[:R] for v in (t, tri, b1, b2))
    return TraceResult(tri >= 0, t, tri, b1, b2)
