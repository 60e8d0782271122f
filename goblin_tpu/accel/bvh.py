"""Host-side BVH build over the world-space triangle soup.

Re-design of the reference's two-level CPU BVH
(src/GoblinBVH.cpp:34-280): instances are flattened to world space at bake
time and ONE global BVH is built, laid out in DFS pre-order with *skip
links* so device traversal is stackless and uniform across the ray
wavefront — every lane advances with

    node = hit_and_inner ? node + 1 : miss_link[node]

which needs no per-ray stack (vs. the reference's per-ray 64-deep
traversal stack, src/GoblinBVH.cpp:234-280): the same walk runs as a
lockstep wavefront loop (accel/traverse) and as one ray per GPU lane
(ops/trace_kernel).

Build strategy: top-down binned-SAH split on the longest centroid axis
with median fallback, leaves up to `max_leaf` triangles reordered to be
contiguous, so leaf tests are dense vector loads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BVHArrays:
    """Flattened BVH in DFS pre-order with skip links (host, numpy)."""

    bounds: np.ndarray  # (N, 6) f32: bmin xyz, bmax xyz
    meta: np.ndarray  # (N, 3) i32: [first_tri, tri_count (0=inner), miss_link]
    order: np.ndarray  # (T,) i32: triangle reordering (soup index per slot)

    @property
    def num_nodes(self) -> int:
        return int(self.bounds.shape[0])


def build_bvh(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    max_leaf: int = 4,
    n_bins: int = 16,
) -> BVHArrays:
    """Build from triangle vertex arrays (T, 3) each.

    Prefers the native C++ builder (native/bvh_builder.cpp) and falls back
    to the pure-python implementation below when the library is absent.
    """
    from ..native import build_bvh as native_build

    res = native_build(v0, v1, v2, max_leaf=max_leaf, n_bins=n_bins)
    if res is not None:
        bounds, meta, order = res
        return BVHArrays(bounds=bounds, meta=meta, order=order)
    return _build_bvh_python(v0, v1, v2, max_leaf, n_bins)


def _build_bvh_python(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    max_leaf: int = 4,
    n_bins: int = 16,
) -> BVHArrays:
    """Pure-python reference builder (slow; used when native is absent)."""
    T = v0.shape[0]
    tri_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centers = (0.5 * (tri_min + tri_max)).astype(np.float32)

    # Growable node storage
    bounds_list: list[np.ndarray] = []
    meta_list: list[list[int]] = []
    order = np.empty(T, dtype=np.int32)
    order_pos = 0

    # Iterative DFS with explicit stack so deep meshes don't hit the
    # Python recursion limit. Children are pushed right-then-left so the
    # left child is emitted immediately after its parent (pre-order).
    # Miss links are patched afterwards from subtree extents.
    import sys

    def leaf_cost(n):
        return float(n)

    def sah_split(idx):
        """Return (axis, left_idx, right_idx) or None for leaf."""
        n = idx.shape[0]
        if n <= max_leaf:
            return None
        cmin = centers[idx].min(axis=0)
        cmax = centers[idx].max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        if extent[axis] <= 1e-12:
            # all centroids coincide: arbitrary equal split
            half = n // 2
            return axis, idx[:half], idx[half:]
        # binned SAH
        scale = n_bins * (1.0 - 1e-6) / extent[axis]
        bin_id = ((centers[idx, axis] - cmin[axis]) * scale).astype(np.int32)
        counts = np.bincount(bin_id, minlength=n_bins)
        # per-bin bounds
        bin_min = np.full((n_bins, 3), np.inf, dtype=np.float64)
        bin_max = np.full((n_bins, 3), -np.inf, dtype=np.float64)
        for a in range(3):
            np.minimum.at(bin_min[:, a], bin_id, tri_min[idx, a])
            np.maximum.at(bin_max[:, a], bin_id, tri_max[idx, a])

        def area_of(lo, hi):
            d = np.maximum(hi - lo, 0.0)
            return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

        # prefix/suffix sweep
        lmin = np.minimum.accumulate(bin_min, axis=0)
        lmax = np.maximum.accumulate(bin_max, axis=0)
        rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
        lcount = np.cumsum(counts)
        rcount = n - lcount
        cost = np.full(n_bins - 1, np.inf)
        valid = (lcount[:-1] > 0) & (rcount[:-1] > 0)
        la = area_of(lmin[:-1], lmax[:-1])
        ra = area_of(rmin[1:], rmax[1:])
        cost[valid] = (
            la[valid] * lcount[:-1][valid] + ra[valid] * rcount[:-1][valid]
        )
        best = int(np.argmin(cost))
        if not np.isfinite(cost[best]):
            half = n // 2
            part = np.argsort(centers[idx, axis], kind="stable")
            return axis, idx[part[:half]], idx[part[half:]]
        go_left = bin_id <= best
        left, right = idx[go_left], idx[~go_left]
        if left.size == 0 or right.size == 0:  # numeric corner: median fallback
            half = n // 2
            part = np.argsort(centers[idx, axis], kind="stable")
            left, right = idx[part[:half]], idx[part[half:]]
        return axis, left, right

    # node records: (bmin, bmax, first, count); subtree sizes for miss links
    subtree_end: list[int] = []  # filled post-order via stack bookkeeping

    stack = [(np.arange(T, dtype=np.int64), None)]
    parent_of: list[int] = []
    # We do an explicit build emitting nodes in pre-order; to patch miss
    # links we record for each node the index just past its subtree.
    # Simplest: rebuild with a recursive helper using our own stack frames.

    bounds_out: list[tuple] = []
    meta_out: list[list[int]] = []

    def emit(idx) -> int:
        """Emit subtree for triangle indices idx; return node id."""
        nonlocal order_pos
        my_id = len(bounds_out)
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        bounds_out.append((bmin, bmax))
        meta_out.append([0, 0, 0])  # patched below
        split = sah_split(idx)
        if split is None:
            first = order_pos
            order[first : first + idx.shape[0]] = idx
            order_pos += idx.shape[0]
            meta_out[my_id][0] = first
            meta_out[my_id][1] = idx.shape[0]
        else:
            _, left, right = split
            emit(left)
            emit(right)
        # miss link = next pre-order node after my subtree
        meta_out[my_id][2] = len(bounds_out)
        return my_id

    sys.setrecursionlimit(max(10000, 64 + 2 * T))
    emit(np.arange(T, dtype=np.int64))

    bounds = np.concatenate(
        [np.stack([b for b, _ in bounds_out]), np.stack([b for _, b in bounds_out])],
        axis=1,
    ).astype(np.float32)
    meta = np.asarray(meta_out, dtype=np.int32)
    return BVHArrays(bounds=bounds, meta=meta, order=order)
