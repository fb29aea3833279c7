"""Ray tracing: host-built BVH + vectorized stackless traversal in XLA.

The reference lists raytracing as an unimplemented roadmap item
(README.md:19); BASELINE.json configs[4] asks for a "raytraced reference
mode: BVH build + ray-triangle intersection replacing the rasterizer".

Shape: the BVH is built once on the host (median split over
centroids, binary, LEAF_SIZE triangles per leaf) and flattened in DFS
*preorder* with skip pointers (a threaded BVH). Traversal then needs no
per-ray stack: every ray holds one node cursor, and each lockstep iteration
does one AABB slab test per ray and moves to `node + 1` (descend) or
`skip[node]` (advance) — pure masked vector ops that XLA fuses. Leaves run Möller–Trumbore on a fixed-size
triangle block.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

LEAF_SIZE = 4


class BVH(NamedTuple):
    # DFS-preorder flattened nodes; leaf iff count > 0; skip = next node in
    # preorder that is not a descendant (-1 past the end).
    bb_min: Array  # (N, 3) f32
    bb_max: Array  # (N, 3) f32
    first: Array  # (N,) i32 first-triangle offset (leaves; 0 for inner)
    count: Array  # (N,) i32 0 for inner nodes
    skip: Array  # (N,) i32
    # Reordered triangle data:
    v0: Array  # (T, 3) f32
    e1: Array  # (T, 3) f32  (v1 - v0)
    e2: Array  # (T, 3) f32  (v2 - v0)
    tri_id: Array  # (T,) i32 original triangle index

    @property
    def num_nodes(self) -> int:
        return self.count.shape[0]


def _build_nodes(t, lo, hi, centroid):
    """Median-split build returning (nodes list in DFS preorder, leaf order).

    Each node dict: bb_min, bb_max, first, count, size (subtree node count);
    the skip pointer is then simply node_index + size.
    """
    nodes = []
    leaf_tris = []

    # Manual stack with post-processing to fill subtree sizes.
    # Entry: (phase, idx, node_pos)
    work = [(0, np.arange(len(t)), None)]
    while work:
        phase, idx, pos = work.pop()
        if phase == 1:  # post: fix subtree size
            nodes[pos]["size"] = len(nodes) - pos
            continue
        node = {
            "bb_min": lo[idx].min(axis=0),
            "bb_max": hi[idx].max(axis=0),
            "first": 0,
            "count": 0,
            "size": 1,
        }
        pos = len(nodes)
        nodes.append(node)
        if len(idx) <= LEAF_SIZE:
            node["first"] = sum(len(x) for x in leaf_tris)
            node["count"] = len(idx)
            leaf_tris.append(idx)
            continue
        c = centroid[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        med = np.argsort(c[:, axis], kind="stable")
        half = len(idx) // 2
        work.append((1, None, pos))  # size fixup after both subtrees emit
        work.append((0, idx[med[half:]], None))  # right (emitted second)
        work.append((0, idx[med[:half]], None))  # left (emitted first)
    return nodes, leaf_tris


def build_bvh(tris_world: np.ndarray) -> BVH:
    """tris_world: (T, 3, 3) float. Host-side median-split threaded BVH."""
    t = np.asarray(tris_world, np.float32)
    if len(t) == 0:
        t = np.zeros((1, 3, 3), np.float32)
    lo = t.min(axis=1)
    hi = t.max(axis=1)
    centroid = (lo + hi) * 0.5
    nodes, leaf_tris = _build_nodes(t, lo, hi, centroid)
    n = len(nodes)
    skip = np.fromiter((i + nd["size"] for i, nd in enumerate(nodes)), np.int32, n)
    skip[skip >= n] = -1
    flat = np.concatenate(leaf_tris)
    tv = t[flat]
    return BVH(
        bb_min=jnp.asarray(np.stack([nd["bb_min"] for nd in nodes]).astype(np.float32)),
        bb_max=jnp.asarray(np.stack([nd["bb_max"] for nd in nodes]).astype(np.float32)),
        first=jnp.asarray(np.asarray([nd["first"] for nd in nodes], np.int32)),
        count=jnp.asarray(np.asarray([nd["count"] for nd in nodes], np.int32)),
        skip=jnp.asarray(skip),
        v0=jnp.asarray(tv[:, 0]),
        e1=jnp.asarray(tv[:, 1] - tv[:, 0]),
        e2=jnp.asarray(tv[:, 2] - tv[:, 0]),
        tri_id=jnp.asarray(flat.astype(np.int32)),
    )


class Hits(NamedTuple):
    t: Array  # (R,) f32 hit distance (t_max = miss)
    tri: Array  # (R,) i32 original triangle id (-1 = miss)
    u: Array  # (R,) f32 barycentric of corner 1
    v: Array  # (R,) f32 barycentric of corner 2


def trace(
    bvh: BVH, origin: Array, direction: Array, t_max=3.0e38, any_hit: bool = False
) -> Hits:
    """Closest-hit (or any-hit) trace of (R, 3) rays. Lockstep: iterates
    until every ray's node cursor ran off the tree."""
    r = origin.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(direction) < 1e-20, 1e-20, direction)
    leaf_pad = bvh.v0.shape[0]

    def cond(state):
        node = state[0]
        return jnp.any(node >= 0)

    def body(state):
        node, best_t, best_tri, best_u, best_v = state
        active = node >= 0
        nidx = jnp.maximum(node, 0)

        nmin = bvh.bb_min[nidx]
        nmax = bvh.bb_max[nidx]
        t0 = (nmin - origin) * inv_d
        t1 = (nmax - origin) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1), axis=1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=1)
        hit_box = active & (tf >= jnp.maximum(tn, 0.0)) & (tn < best_t)

        cnt = bvh.count[nidx]
        first = bvh.first[nidx]
        is_leaf = hit_box & (cnt > 0)

        for k in range(LEAF_SIZE):
            ti = jnp.minimum(first + k, leaf_pad - 1)
            ok = is_leaf & (k < cnt)
            v0 = bvh.v0[ti]
            e1 = bvh.e1[ti]
            e2 = bvh.e2[ti]
            pvec = jnp.cross(direction, e2)
            det = jnp.sum(e1 * pvec, axis=1)
            ok = ok & (jnp.abs(det) > 1e-12)
            idet = 1.0 / jnp.where(det == 0, 1.0, det)
            tvec = origin - v0
            u = jnp.sum(tvec * pvec, axis=1) * idet
            qvec = jnp.cross(tvec, e1)
            v = jnp.sum(direction * qvec, axis=1) * idet
            th = jnp.sum(e2 * qvec, axis=1) * idet
            ok = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (th > 1e-5) & (th < best_t)
            best_t = jnp.where(ok, th, best_t)
            best_tri = jnp.where(ok, bvh.tri_id[ti], best_tri)
            best_u = jnp.where(ok, u, best_u)
            best_v = jnp.where(ok, v, best_v)

        descend = hit_box & (cnt == 0)
        nxt = jnp.where(descend, nidx + 1, bvh.skip[nidx])
        node = jnp.where(active, nxt, node)
        if any_hit:
            node = jnp.where(best_tri >= 0, -1, node)
        return node, best_t, best_tri, best_u, best_v

    state = (
        jnp.zeros((r,), jnp.int32),
        jnp.full((r,), t_max, jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    node, best_t, best_tri, best_u, best_v = jax.lax.while_loop(cond, body, state)
    return Hits(t=best_t, tri=best_tri, u=best_u, v=best_v)
