"""BVH construction for the stackless traversal (ops/traversal.py).

The reference delegates acceleration-structure builds to the Vulkan driver
(src/geometry.rs:35-44, src/scene/builder.rs:143-179,454-468). Here we
build our own. The traversal-time data structure is a **unified DFS stream**
designed for lock-step SIMD traversal (no stack, no per-lane control flow):

  - The tree is flattened depth-first into a single record stream.
  - Every node (inner or leaf) emits one *box* record; a leaf's triangles are
    inlined as *triangle* records immediately after the leaf's box.
  - A single int32 side-array drives control flow:
      skip[i] >= 0  -> record is a box; on AABB miss jump to skip[i],
                       on hit fall through to i+1 (first child / first tri).
      skip[i] == -1 -> record is a triangle; always fall through to i+1
                       (after the last triangle of a leaf, i+1 is exactly the
                       node the leaf's skip would target, by DFS layout).
  - Stream index == len(stream) is the termination sentinel, so the traversal
    loop is `while ptr < S`, identical for every lane.

Each step of the traversal therefore performs one 12-float gather plus both
an AABB slab test and a Moller-Trumbore test, selecting the relevant result
per lane - zero divergence on the VPU.

Record layout (rec[i, 0:12] f32):
  box: [min.x min.y min.z  max.x max.y max.z  0 0 0 0 0 0]
  tri: [v0.x v0.y v0.z     e1.x e1.y e1.z     e2.x e2.y e2.z  0 0 0]

Builder: binned-SAH (16 bins) top-down, numpy host-side (the analogue of the
reference's driver-side `build_acceleration_structures`). A device-side
refit path updates box records bottom-up per level for per-frame TLAS-style
instance motion (BASELINE.md config 4).
"""

from __future__ import annotations

import dataclasses

import numpy as np

LEAF_SIZE = 4
NUM_BINS = 16
REC_WIDTH = 12


@dataclasses.dataclass
class BVH:
    """Flattened unified-stream BVH (host numpy; uploaded by the scene build)."""

    rec: np.ndarray        # [S, 12] f32 unified records
    skip: np.ndarray       # [S] i32: box -> miss target; tri -> -1
    tri_id: np.ndarray     # [S] i32: tri -> ORIGINAL triangle index; box -> -1
    # --- refit metadata (box records only; -1 elsewhere) ---
    box_left: np.ndarray   # [S] i32 stream index of left child box (-1 if leaf box)
    box_right: np.ndarray  # [S] i32 stream index of right child box
    depth: np.ndarray      # [S] i32 tree depth of each box record (-1 for tris)
    max_depth: int

    @property
    def size(self) -> int:
        return len(self.skip)


def build_bvh_native(aabb_min: np.ndarray, aabb_max: np.ndarray,
                     leaf_size: int = LEAF_SIZE,
                     num_bins: int = NUM_BINS):
    """C++ binned-SAH builder (runtime/native); None if unavailable."""
    from ..runtime import native

    lib = native.get_lib()
    if lib is None:
        return None
    t = aabb_min.shape[0]
    cap = 3 * max(t, 1) + 8
    mn = np.ascontiguousarray(aabb_min, np.float32)
    mx = np.ascontiguousarray(aabb_max, np.float32)
    rec = np.zeros((cap, REC_WIDTH), np.float32)
    skip = np.zeros((cap,), np.int32)
    tri = np.zeros((cap,), np.int32)
    left = np.zeros((cap,), np.int32)
    right = np.zeros((cap,), np.int32)
    depth = np.zeros((cap,), np.int32)
    out_depth = np.zeros((1,), np.int32)
    s = lib.tpurt_build_bvh(
        mn.ctypes.data, mx.ctypes.data, t, leaf_size, num_bins,
        rec.ctypes.data, skip.ctypes.data, tri.ctypes.data,
        left.ctypes.data, right.ctypes.data, depth.ctypes.data,
        out_depth.ctypes.data, cap)
    if s < 0:
        return None
    if s == 0:  # empty scene sentinel matches the python builder
        s = 1
        skip[0] = 1
        tri[0] = -1
        left[0] = right[0] = depth[0] = -1
    return BVH(rec=rec[:s].copy(), skip=skip[:s].copy(),
               tri_id=tri[:s].copy(), box_left=left[:s].copy(),
               box_right=right[:s].copy(), depth=depth[:s].copy(),
               max_depth=int(out_depth[0]))


def build_bvh(aabb_min: np.ndarray, aabb_max: np.ndarray,
              leaf_size: int = LEAF_SIZE, num_bins: int = NUM_BINS) -> tuple:
    """Build over triangle AABBs. Returns (BVH, tri-record-filler callback).

    ``aabb_min/max``: [T, 3] float32 per-triangle bounds.
    The returned BVH's `rec` has triangle slots zero-filled; call
    `fill_triangles(bvh, v0, e1, e2)` with ORIGINAL-indexed arrays to
    populate them (kept separate so refit/updates can re-fill cheaply).

    Uses the native C++ builder when available (identical stream format);
    the Python implementation below is the reference and fallback.
    """
    native_tree = build_bvh_native(aabb_min, aabb_max, leaf_size, num_bins)
    if native_tree is not None:
        return native_tree
    t_count = aabb_min.shape[0]
    centroids = (aabb_min + aabb_max) * 0.5

    # --- recursive binned-SAH build (explicit node list, DFS order) ---
    stream_skip: list = []
    stream_tri: list = []
    stream_box_min: list = []
    stream_box_max: list = []
    stream_left: list = []
    stream_right: list = []
    stream_depth: list = []
    max_depth_seen = [0]

    def emit_placeholder() -> int:
        idx = len(stream_skip)
        stream_skip.append(0)
        stream_tri.append(-1)
        stream_box_min.append(None)
        stream_box_max.append(None)
        stream_left.append(-1)
        stream_right.append(-1)
        stream_depth.append(-1)
        return idx

    def build_node(tri_idx: np.ndarray, depth: int) -> int:
        """Emit subtree for triangles `tri_idx`; return its stream index."""
        max_depth_seen[0] = max(max_depth_seen[0], depth)
        node_min = aabb_min[tri_idx].min(axis=0)
        node_max = aabb_max[tri_idx].max(axis=0)
        my = emit_placeholder()
        stream_box_min[my] = node_min
        stream_box_max[my] = node_max
        stream_depth[my] = depth

        n = len(tri_idx)
        if n <= leaf_size:
            for t in tri_idx:
                ti = emit_placeholder()
                stream_skip[ti] = -1
                stream_tri[ti] = int(t)
            stream_skip[my] = len(stream_skip)  # patched: == after-subtree
            return my

        # binned SAH over the widest centroid axis; median fallback
        cent = centroids[tri_idx]
        ext = cent.max(axis=0) - cent.min(axis=0)
        axis = int(np.argmax(ext))
        left_sel = None
        if ext[axis] > 1e-12:
            cmin = cent[:, axis].min()
            scale = num_bins * (1.0 - 1e-6) / max(ext[axis], 1e-12)
            bins = np.minimum(((cent[:, axis] - cmin) * scale).astype(np.int32),
                              num_bins - 1)
            best_cost, best_split = np.inf, -1
            bin_counts = np.bincount(bins, minlength=num_bins)
            # per-bin AABBs
            bmin = np.full((num_bins, 3), np.inf)
            bmax = np.full((num_bins, 3), -np.inf)
            for b in range(num_bins):
                sel = bins == b
                if bin_counts[b]:
                    bmin[b] = aabb_min[tri_idx[sel]].min(axis=0)
                    bmax[b] = aabb_max[tri_idx[sel]].max(axis=0)
            # sweep
            lmin = np.minimum.accumulate(bmin, axis=0)
            lmax = np.maximum.accumulate(bmax, axis=0)
            rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
            lcnt = np.cumsum(bin_counts)
            rcnt = n - lcnt

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            for s in range(num_bins - 1):
                if lcnt[s] == 0 or rcnt[s] == 0:
                    continue
                cost = area(lmin[s:s + 1], lmax[s:s + 1])[0] * lcnt[s] + \
                    area(rmin[s + 1:s + 2], rmax[s + 1:s + 2])[0] * rcnt[s]
                if cost < best_cost:
                    best_cost, best_split = cost, s
            if best_split >= 0:
                left_sel = bins <= best_split
        if left_sel is None or left_sel.all() or not left_sel.any():
            # median split on the widest axis
            order = np.argsort(cent[:, axis], kind="stable")
            half = n // 2
            left_sel = np.zeros(n, dtype=bool)
            left_sel[order[:half]] = True

        left_idx = tri_idx[left_sel]
        right_idx = tri_idx[~left_sel]
        li = build_node(left_idx, depth + 1)
        ri = build_node(right_idx, depth + 1)
        stream_left[my] = li
        stream_right[my] = ri
        stream_skip[my] = len(stream_skip)  # after both subtrees
        return my

    if t_count > 0:
        # enable deep recursion for big meshes
        import sys
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 10000))
        try:
            build_node(np.arange(t_count, dtype=np.int64), 0)
        finally:
            sys.setrecursionlimit(old_limit)

    s = len(stream_skip)
    rec = np.zeros((max(s, 1), REC_WIDTH), np.float32)
    skip = np.full((max(s, 1),), 0, np.int32)
    tri = np.full((max(s, 1),), -1, np.int32)
    left = np.full((max(s, 1),), -1, np.int32)
    right = np.full((max(s, 1),), -1, np.int32)
    depth_arr = np.full((max(s, 1),), -1, np.int32)
    for i in range(s):
        skip[i] = stream_skip[i]
        tri[i] = stream_tri[i]
        left[i] = stream_left[i]
        right[i] = stream_right[i]
        depth_arr[i] = stream_depth[i]
        if stream_box_min[i] is not None:
            rec[i, 0:3] = stream_box_min[i]
            rec[i, 3:6] = stream_box_max[i]
    if s == 0:
        skip[0] = 1  # empty scene: single degenerate box that always misses

    return BVH(rec=rec, skip=skip, tri_id=tri, box_left=left, box_right=right,
               depth=depth_arr, max_depth=max_depth_seen[0])


def fill_triangles(bvh: BVH, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> None:
    """Populate triangle records from ORIGINAL-indexed triangle arrays."""
    is_tri = bvh.skip < 0
    ids = bvh.tri_id[is_tri]
    bvh.rec[is_tri, 0:3] = v0[ids]
    bvh.rec[is_tri, 3:6] = e1[ids]
    bvh.rec[is_tri, 6:9] = e2[ids]
