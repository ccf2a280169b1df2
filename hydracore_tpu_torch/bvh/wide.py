"""Wide (8-ary) BVH: collapse of the binary SAH tree into packed records.

The port's own copy of the JAX package's bvh/wide.py (same bytes out for
the same tree). An 8-wide node cuts the number of traversal steps about
threefold against the binary tree, and each node is one packed record, so
a step fetches one row:

    nodes:  (N, 8, 8) float32 - per child slot:
            [bmin.xyz, bmax.xyz, child_payload, unused]
            child_payload (bitcast int32): >= 0 -> wide-node index,
            < 0 -> -(leaf_block + 1). Empty slots carry NaN boxes and the
            payload EMPTY_PAYLOAD; a traversal must test the payload, since
            CUDA's fminf/fmaxf drop a NaN operand.
    tri9:   (B * LEAF_SIZE, 9) float32 - v0, e1, e2 per padded slot; every
            leaf block owns exactly LEAF_SIZE aligned slots (degenerate
            padding), so a leaf is one aligned (LEAF_SIZE, 9) fetch and a
            dense Moller-Trumbore.
    slot_tri: (B * LEAF_SIZE,) int32 - padded slot -> original triangle id.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hydracore_tpu_torch.bvh.builder import FlatBVH

WIDTH = 8
LEAF_SIZE = 8
EMPTY_PAYLOAD = -(2**30)  # sentinel child payload for unused slots


@dataclass
class WideBVH:
    nodes: np.ndarray  # (N, 8, 8) float32 (payload bitcast in [:, :, 6])
    max_depth: int  # wide-tree depth (root = 1); traversals size stacks by it
    tri9: np.ndarray  # (B*LEAF_SIZE, 9) float32
    tri9f: np.ndarray  # (B, LEAF_SIZE*16) float32 — one 128-float row per
    #                    block (9 floats used per tri slot, padded to 16) so
    #                    a leaf fetch is one aligned row
    slot_tri: np.ndarray  # (B*LEAF_SIZE,) int32
    num_nodes: int
    num_blocks: int


def _area(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]


def collapse_wide(bvh: FlatBVH, tri_v0: np.ndarray, tri_e1: np.ndarray,
                  tri_e2: np.ndarray) -> WideBVH:
    """Collapse a binary FlatBVH into the packed 8-wide layout.

    Triangles must already be in BVH leaf order (builder perm applied)."""
    T = tri_v0.shape[0]

    is_leaf_root = bvh.count[0] > 0

    # blocks of padded triangles
    blocks: list[tuple[int, int]] = []  # (start, count) in leaf order

    nodes: list[np.ndarray] = []  # each (8, 8) float32

    def add_block(start: int, count: int) -> int:
        assert count <= LEAF_SIZE, f"leaf of {count} tris exceeds LEAF_SIZE"
        blocks.append((int(start), int(count)))
        return len(blocks) - 1

    depth_seen = [1]

    def build_wide(b2: int, depth: int = 1) -> int:
        """Returns wide node id for binary node b2 (must be internal)."""
        my_id = len(nodes)
        nodes.append(np.zeros((WIDTH, 8), np.float32))
        depth_seen[0] = max(depth_seen[0], depth)

        # greedy expansion: keep splitting the largest-area internal entry
        entries = [int(bvh.left[b2]), int(bvh.right[b2])]
        while len(entries) < WIDTH:
            best, best_a = -1, -1.0
            for i, e in enumerate(entries):
                if bvh.count[e] == 0:  # internal
                    a = _area(bvh.bmin[e], bvh.bmax[e])
                    if a > best_a:
                        best, best_a = i, a
            if best < 0:
                break
            e = entries.pop(best)
            entries.extend([int(bvh.left[e]), int(bvh.right[e])])

        rec = np.zeros((WIDTH, 8), np.float32)
        rec[:, 0:3] = np.nan  # empty slots: NaN boxes never pass the slab test
        rec[:, 3:6] = np.nan
        payload = np.full(WIDTH, EMPTY_PAYLOAD, np.int32)
        for i, e in enumerate(entries):
            rec[i, 0:3] = bvh.bmin[e]
            rec[i, 3:6] = bvh.bmax[e]
            if bvh.count[e] > 0:
                blk = add_block(bvh.left[e], bvh.count[e])
                payload[i] = -(blk + 1)
            else:
                payload[i] = build_wide(e, depth + 1)
        rec[:, 6] = payload.view(np.float32)
        nodes[my_id] = rec
        return my_id

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        if is_leaf_root:
            # single-leaf scene: one wide node with one leaf child
            rec = np.zeros((WIDTH, 8), np.float32)
            rec[:, 0:3] = np.nan
            rec[:, 3:6] = np.nan
            rec[:, 6] = np.full(WIDTH, EMPTY_PAYLOAD, np.int32).view(np.float32)
            rec[0, 0:3] = bvh.bmin[0]
            rec[0, 3:6] = bvh.bmax[0]
            blk = add_block(bvh.left[0], bvh.count[0])
            rec[0, 6] = np.int32(-(blk + 1)).view(np.float32)
            nodes.append(rec)
        else:
            build_wide(0)
    finally:
        sys.setrecursionlimit(old_limit)

    # pack padded triangle blocks
    B = max(len(blocks), 1)
    tri9 = np.zeros((B * LEAF_SIZE, 9), np.float32)
    tri9[:, 0:3] = 1e30  # degenerate padding: far-away zero-area tris
    slot_tri = np.zeros(B * LEAF_SIZE, np.int32)
    for b, (start, count) in enumerate(blocks):
        count = min(count, LEAF_SIZE)
        s = b * LEAF_SIZE
        tri9[s : s + count, 0:3] = tri_v0[start : start + count]
        tri9[s : s + count, 3:6] = tri_e1[start : start + count]
        tri9[s : s + count, 6:9] = tri_e2[start : start + count]
        slot_tri[s : s + count] = np.arange(start, start + count, dtype=np.int32)

    tri9f = np.zeros((B, LEAF_SIZE, 16), np.float32)
    tri9f[:, :, 0:3] = 1e30
    tri9f[:, :, 0:9] = tri9.reshape(B, LEAF_SIZE, 9)

    return WideBVH(
        max_depth=int(depth_seen[0]),
        nodes=np.stack(nodes).astype(np.float32),
        tri9=tri9,
        tri9f=tri9f.reshape(B, LEAF_SIZE * 16),
        slot_tri=slot_tri,
        num_nodes=len(nodes),
        num_blocks=B,
    )
