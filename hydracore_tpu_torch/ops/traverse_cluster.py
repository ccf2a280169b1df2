"""Cluster traversal: kernels B1 (closest hit), B2 (any hit) and B3 (the
same two over the instanced layout), their plain PyTorch twin, and the
closest_hit / any_hit epilogues.

The kernels (csrc/traverse_cluster.cu, CUDA C++ for sm_90a, built with
nvcc at first use and loaded with ctypes) replace the JAX package's Pallas
kernel hydracore_tpu/ops/traverse_cluster.py::_make_kernel as launched by
_cluster_traverse, in its flat and its inst_mode variants, and the chain
of launches of _partitioned_traverse: a partitioned pool is walked inside
ONE launch. They compute the same function, not its TPU block structure:
one two-level walk. It votes on the boxes of an upper level first and walks
a box's clusters only when a ray of the block enters it: groups of clusters
for B1/B2 (bvh/clusters.py:group_tables, all chunks in one front-to-back
order, every group in turn), instances for B3 under a tree that it walks
from the root (bvh/instanced.py:instance_tables). The source note in the
.cu file gives the design and its bound. walk_counts gives the votes and
member positions a block's walk takes, at least and at most.

cluster_traverse() is the wrapper: for CUDA tensors it launches the kernel
(or raises), for CPU tensors it runs cluster_traverse_plain, the twin with
the same contract. It counts kernel launches in closest_launches /
any_launches (B1/B2), opaque_any_launches (B2 over the opaque shadow pool
of an alpha scene), ao_any_launches (B2 on the path tracer's AO probes)
and inst_closest_launches / inst_any_launches (B3): module attributes
read from the always-counted counters of utils/spans.py. While spans
record, B3 also counts its blocks' upper-level votes on the card
(VOTES_COUNTER).
"""
from __future__ import annotations

import torch

from hydracore_tpu_torch.bvh.instanced import TREE_FAN
from hydracore_tpu_torch.ops.intersect import (mt_refine, safe_inv,
                                                want_double)
from hydracore_tpu_torch.utils import spans
from hydracore_tpu_torch.utils.build import CI, VP, launch, load_lib

BIG = 3.0e38
LANES = 128
# rays per CTA (one thread per ray): the coherence unit of the box-test
# pruning. Bounce wavefronts are less coherent than primary and shadow
# ones, so they use smaller blocks (the JAX package's defaults).
R_BLK = 256
R_BLK_BOUNCE = 128

LAUNCH_COUNTERS = ("closest_launches", "any_launches",
                   "inst_closest_launches", "inst_any_launches",
                   "opaque_any_launches", "ao_any_launches")

_lib = None


def __getattr__(name):
    if name in LAUNCH_COUNTERS:
        return spans.value("traverse_cluster." + name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launch_counts() -> None:
    spans.reset(*("traverse_cluster." + k for k in LAUNCH_COUNTERS))


# the upper level of the two-level walk, in the order the kernel takes it:
# the upper boxes (8, N), per octant their front-to-back order (8, N), per
# octant the members grouped by upper box (8, M), the members' boxes in that
# order (8, 8, M), each box's offset into the members (N + 1,), and a tree
# over the upper boxes: per octant the children of each of its Nn inner
# nodes, front to back (8, Nn * TREE_FAN), and the nodes' boxes (8, Nn).
# B1/B2's boxes are groups of clusters (bvh/clusters.py:group_tables), with
# no tree (Nn = 0: they vote on every group in turn, in the flat order);
# B3's the instances under a tree that B3 walks from its root, with no flat
# order ((8, 0); bvh/instanced.py:instance_tables).
LEVEL_TABLES = ("lvl_bounds", "lvl_oct_perm", "lvl_members",
                "lvl_member_bounds", "lvl_start", "lvl_nodes",
                "lvl_node_bounds")
# the counter of B3's upper-level votes (utils/spans.py), counted on the
# card while spans record
VOTES_COUNTER = "traverse_cluster.b3_upper_votes"


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = load_lib("traverse_cluster.cu", "hydra_cluster_traverse",
                        [VP] * 14 + [CI] * 6 + [VP])
    return _lib


def _check_inputs(rays, cbl_oct, tris, perm, cl_map, inst_woop, level):
    """Validate shapes, types and devices. `level` maps LEVEL_TABLES to the
    upper level's tensors (all None when not given); cbl_oct and perm may
    be None (only the twin reads them)."""
    if rays.dim() != 3 or rays.shape[2] != 8:
        raise ValueError(f"rays must be (G, r_blk, 8), got {tuple(rays.shape)}")
    if (cl_map is None) != (inst_woop is None):
        raise ValueError("cl_map and inst_woop come together")
    if (cbl_oct is None) != (perm is None):
        raise ValueError("cbl_oct and perm come together")
    given = [k for k, x in level.items() if x is not None]
    if given and len(given) != len(LEVEL_TABLES):
        raise ValueError(f"the upper level {LEVEL_TABLES} comes whole")
    inst = cl_map is not None
    tensors = [("rays", rays, torch.float32), ("tris", tris, torch.float32)]
    if cbl_oct is not None:
        lead = tuple(cbl_oct.shape[:-3]) if cbl_oct.dim() in (3, 4) else None
        Cp = cbl_oct.shape[-1] if lead is not None else -1
        if lead is None or tuple(cbl_oct.shape[-3:]) != (8, 8, Cp) or Cp <= 0:
            raise ValueError("cbl_oct must be (8, 8, Cp) or (P, 8, 8, Cp), "
                             f"got {tuple(cbl_oct.shape)}")
        if tuple(perm.shape) != lead + (8, Cp):
            raise ValueError(f"perm must be {lead + (8, Cp)}, got "
                             f"{tuple(perm.shape)}")
        tensors += [("cbl_oct", cbl_oct, torch.float32),
                    ("perm", perm, torch.int32)]
    elif inst:
        lead, Cp = (), cl_map.shape[-1]
    elif tris.dim() in (3, 4):
        lead, Cp = tuple(tris.shape[:-3]), tris.shape[-3]
    else:
        raise ValueError("tris must be (Cp, 4, 384) or (P, Cp, 4, 384), got "
                         f"{tuple(tris.shape)}")
    if not inst:
        if tuple(tris.shape) != lead + (Cp, 4, 3 * LANES):
            raise ValueError(f"tris must be {lead + (Cp, 4, 3 * LANES)}, got "
                             f"{tuple(tris.shape)}")
    else:
        if lead:
            raise ValueError("an instanced pool is not partitioned")
        if tris.dim() != 3 or tuple(tris.shape[1:]) != (4, 3 * LANES):
            raise ValueError(f"tris must be (Cpool, 4, 384), got {tuple(tris.shape)}")
        if tuple(cl_map.shape) != (2, Cp):
            raise ValueError(f"cl_map must be (2, {Cp}), got {tuple(cl_map.shape)}")
        if inst_woop.dim() != 3 or tuple(inst_woop.shape[1:]) != (4, 4):
            raise ValueError(f"inst_woop must be (I, 4, 4), got "
                             f"{tuple(inst_woop.shape)}")
        tensors += [("cl_map", cl_map, torch.int32),
                    ("inst_woop", inst_woop, torch.float32)]
    if given:
        N = level["lvl_bounds"].shape[-1]
        M = level["lvl_members"].shape[-1]
        Nn = level["lvl_node_bounds"].shape[-1]
        if inst and N != inst_woop.shape[0]:
            raise ValueError(f"lvl_bounds holds {N} boxes, the instances "
                             f"{inst_woop.shape[0]}")
        if inst != (Nn > 0):
            raise ValueError("B3 walks a tree of at least one node, B1/B2 "
                             f"none: lvl_node_bounds holds {Nn} nodes")
        if M > (lead[0] if lead else 1) * Cp:
            raise ValueError(f"lvl_members holds {M} clusters, the pool "
                             f"{(lead[0] if lead else 1) * Cp}")
        for name, shape, dt in (
                ("lvl_bounds", (8, N), torch.float32),
                ("lvl_oct_perm", (8, 0 if inst else N), torch.int32),
                ("lvl_members", (8, M), torch.int32),
                ("lvl_member_bounds", (8, 8, M), torch.float32),
                ("lvl_start", (N + 1,), torch.int32),
                ("lvl_nodes", (8, Nn * TREE_FAN), torch.int32),
                ("lvl_node_bounds", (8, Nn), torch.float32)):
            if tuple(level[name].shape) != shape:
                raise ValueError(f"{name} must be {shape}, got "
                                 f"{tuple(level[name].shape)}")
            tensors.append((name, level[name], dt))
    for name, x, dt in tensors:
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rays.device}")


def cluster_traverse(rays, cbl_oct=None, tris=None, perm=None,
                     any_hit_mode: bool = False, cl_map=None, inst_woop=None,
                     lvl_bounds=None, lvl_oct_perm=None, lvl_members=None,
                     lvl_member_bounds=None, lvl_start=None,
                     lvl_nodes=None, lvl_node_bounds=None,
                     opaque_pool: bool = False, ao_probes: bool = False):
    """rays (G, r_blk, 8) f32 [o d t_lim active] -> (t (G, r_blk) f32,
    slot (G, r_blk) i32). The pool is flat (tris (Cp, 4, 384)), partitioned
    (a leading chunk axis P on tris, cbl_oct and perm; slots come back as
    (chunk * Cp + cluster) * 128 + lane) or, with cl_map and inst_woop,
    instanced (tris the shared pool, cbl_oct and perm over
    instance-clusters). CUDA tensors launch kernel B1 / B2, or B3 for an
    instanced pool, which walk the upper level LEVEL_TABLES (a scene's
    fields of those names, scene_pool) and raise without it. CPU tensors run
    the plain twin, which needs cbl_oct and perm and no level.
    `opaque_pool` says that tris is a scene's opaque shadow pool
    (cl_tris_shadow: the alpha lanes zeroed, so that t = -0/0 = NaN fails
    every test; scene_pool(scene, opaque_only=True) sets it with that
    pool); it changes no arithmetic, only the counter: B2 over that pool
    counts in opaque_any_launches. Likewise `ao_probes` says that the rays
    are the path tracer's AO probes (integrators/pt.py:ao_probe): B2 on
    them counts in ao_any_launches (B3 in inst_any_launches still)."""
    if tris is None:
        raise ValueError("tris is required")
    level = dict(lvl_bounds=lvl_bounds, lvl_oct_perm=lvl_oct_perm,
                 lvl_members=lvl_members, lvl_member_bounds=lvl_member_bounds,
                 lvl_start=lvl_start, lvl_nodes=lvl_nodes,
                 lvl_node_bounds=lvl_node_bounds)
    _check_inputs(rays, cbl_oct, tris, perm, cl_map, inst_woop, level)
    if not rays.is_cuda:
        if cbl_oct is None:
            raise ValueError("the plain twin (CPU tensors) needs cbl_oct and "
                             "perm")
        return cluster_traverse_plain(rays, cbl_oct, tris, perm, any_hit_mode,
                                      cl_map, inst_woop)
    G, r_blk, _ = rays.shape
    if r_blk > 256:
        raise ValueError(f"r_blk {r_blk} > 256 threads per block")
    inst = cl_map is not None
    if lvl_bounds is None:
        raise ValueError(f"kernel {'B3' if inst else 'B1/B2'} needs the upper "
                         f"level {LEVEL_TABLES} (bvh/"
                         + ("instanced.py:instance_tables)" if inst
                            else "clusters.py:group_tables)"))
    t = torch.empty((G, r_blk), dtype=torch.float32, device=rays.device)
    slot = torch.empty((G, r_blk), dtype=torch.int32, device=rays.device)
    args = [x.contiguous() if x is not None else None
            for x in (rays, tris, cl_map, inst_woop)] \
        + [level[k].contiguous() for k in LEVEL_TABLES]
    # B3's votes, into a device word of their own while spans record (the
    # untraced walk runs no atomic)
    votes = (torch.zeros(1, dtype=torch.int64, device=rays.device)
             if inst and spans.is_recording() else None)
    Nn = lvl_node_bounds.shape[1]
    launch(_kernel_lib(), "hydra_cluster_traverse", "cluster traversal",
           rays.device,
           *(None if x is None or x.numel() == 0 else x.data_ptr()
             for x in args),
           t.data_ptr(), slot.data_ptr(),
           None if votes is None else votes.data_ptr(), G * r_blk, r_blk,
           lvl_members.shape[1], lvl_bounds.shape[1], Nn, int(any_hit_mode))
    if votes is not None:
        spans.count(VOTES_COUNTER, votes)
    pool = ("inst_" if inst else "opaque_" if opaque_pool
            else "ao_" if ao_probes else "")
    hit = "any" if any_hit_mode else "closest"
    spans.bump(f"traverse_cluster.{pool}{hit}_launches")
    return t, slot


# elements of one step of the twin: bounds its (rays x clusters) and
# (ray-cluster pairs x lanes) temporaries to ~16 MiB each
_TWIN_STEP_ELEMS = 1 << 22


def _slab(oi, inv, lo, hi, t_lim):
    """The kernels' slab test, broadcast over all but the first axis (x, y,
    z) of o * inv, inv and the box corners lo and hi, and t_lim: lo * inv -
    o * inv, each operation rounded."""
    t_a = lo * inv - oi
    t_b = hi * inv - oi
    t0, t1 = torch.minimum(t_a, t_b), torch.maximum(t_a, t_b)
    tn = torch.maximum(torch.maximum(t0[0], t0[1]), t0[2])
    tf = torch.minimum(torch.minimum(t1[0], t1[1]), t1[2])
    return (tf >= torch.clamp(tn, min=0.0)) & (tn < t_lim)


def slab_enters(o, inv, bounds, t_lim):
    """(n, C) bool: ray k (origin o[k], inv[k] = safe_inv of its direction)
    enters box c of `bounds` (8, C) [min max 0 0] before t_lim[k], in the
    kernels' arithmetic."""
    return _slab((o * inv).T[:, :, None], inv.T[:, :, None],
                 bounds[0:3, None], bounds[3:6, None], t_lim[:, None])


def _any_enters(flat, inv, act, t, blk, box, RB):
    """(P,) bool: some active ray of block blk[p] (RB rays from row blk[p] *
    RB of flat) enters box[:, p] of (8, P) before its t, in the kernels'
    arithmetic."""
    out = torch.zeros(blk.numel(), dtype=torch.bool, device=flat.device)
    lane = torch.arange(RB, device=flat.device)
    step = max(1, _TWIN_STEP_ELEMS // (8 * RB))  # pairs a step
    for s in range(0, blk.numel(), step):
        rows = (blk[s:s + step, None] * RB + lane).reshape(-1)
        b = box[:, s:s + step].repeat_interleave(RB, dim=1)  # (8, n)
        iv = inv[rows]
        e = _slab((flat[rows, 0:3] * iv).T, iv.T, b[0:3], b[3:6],
                  t[rows]) & act[rows]
        out[s:s + step] = e.reshape(-1, RB).any(dim=1)
    return out


def walk_counts(rays, level, t=None):
    """What B1/B2/B3 walk in each block of `rays` (G, r_blk, 8) over the
    upper level `level` (a scene's scene_pool, say), each active ray tested
    against its t (`t` (G * r_blk,) where given, else its t_lim). Returns
    (votes, members), (G,) int64 each: the upper boxes the block votes on,
    and the members [lvl_start[i], lvl_start[i + 1]) of every upper box i
    that some active ray of the block enters, which the block votes on in
    turn. B1/B2 (no tree) vote on every box, a block without an active ray
    on none. B3 walks its tree (lvl_nodes) from the root: one vote for the
    root and one for each child of every inner node that some active ray
    enters, so a block without an active ray votes once. Against t_lim
    this is the most the walk can take (no hit shortens t), against the
    final t of a closest-hit walk the least: a box test is monotone in
    t."""
    boxes, start = level["lvl_bounds"], level["lvl_start"]
    nodes, node_bounds = level["lvl_nodes"], level["lvl_node_bounds"]
    G, RB, _ = rays.shape
    dev = rays.device
    flat = rays.reshape(-1, 8)
    act = flat[:, 7] > 0.0
    if t is None:
        t = torch.clamp(flat[:, 6], max=BIG)
    inv = safe_inv(flat[:, 3:6])
    sizes = (start[1:] - start[:-1]).to(torch.int64)
    N, Nn = sizes.numel(), node_bounds.shape[1]
    members = torch.zeros(G, dtype=torch.int64, device=dev)
    if Nn == 0:  # B1/B2: every box in turn
        blk = torch.arange(G, device=dev).repeat_interleave(N)
        box = torch.arange(N, device=dev).repeat(G)
        ent = _any_enters(flat, inv, act, t, blk, boxes[:, box], RB)
        members.index_add_(0, blk[ent], sizes[box[ent]])
        live = act.reshape(G, RB).any(dim=1)
        return torch.where(live, N, 0).to(torch.int64), members
    kids = nodes.reshape(8, Nn, TREE_FAN).long()
    d0 = flat[::RB, 3:6]  # a block's octant: its first ray's
    octant = ((d0[:, 0] > 0).long() + 2 * (d0[:, 1] > 0).long()
              + 4 * (d0[:, 2] > 0).long())
    every = torch.cat([boxes, node_bounds], dim=1)  # ids [0, N), N + node
    votes = torch.zeros(G, dtype=torch.int64, device=dev)
    blk = torch.arange(G, device=dev)
    ids = torch.full((G,), N, dtype=torch.int64, device=dev)  # the root
    while blk.numel():
        votes.index_add_(0, blk, torch.ones_like(blk))
        ent = _any_enters(flat, inv, act, t, blk, every[:, ids], RB)
        blk, ids = blk[ent], ids[ent]
        leaf = ids < N
        members.index_add_(0, blk[leaf], sizes[ids[leaf]])
        blk, ids = blk[~leaf], ids[~leaf]
        ch = kids[octant[blk], ids - N]  # (P, TREE_FAN)
        real = ch >= 0
        blk = blk[:, None].expand(-1, TREE_FAN)[real]
        ids = ch[real]
    return votes, members


def _pairs_mt(o, d, t_lim, blk):
    """Woop Moller-Trumbore of K rays, each against the 128 lanes of its own
    block blk (K, 4, 384). Returns (t (K,) of the nearest hit inside
    (1e-5, t_lim), +inf when none; its lane (K,), the lowest among equal
    t)."""
    bu, bv, bw = (blk[:, :, k * LANES:(k + 1) * LANES] for k in range(3))
    ox, oy, oz = (o[:, k, None] for k in range(3))
    dx, dy, dz = (d[:, k, None] for k in range(3))
    ow = ox * bw[:, 0] + oy * bw[:, 1] + oz * bw[:, 2] + bw[:, 3]
    dw = dx * bw[:, 0] + dy * bw[:, 1] + dz * bw[:, 2]
    t = -ow / dw
    u = (ox * bu[:, 0] + oy * bu[:, 1] + oz * bu[:, 2] + bu[:, 3]) \
        + t * (dx * bu[:, 0] + dy * bu[:, 1] + dz * bu[:, 2])
    v = (ox * bv[:, 0] + oy * bv[:, 1] + oz * bv[:, 2] + bv[:, 3]) \
        + t * (dx * bv[:, 0] + dy * bv[:, 1] + dz * bv[:, 2])
    hit = (t > 1e-5) & (t < t_lim[:, None]) & (u >= 0) & (v >= 0) \
        & (u + v <= 1.0)
    tm = torch.where(hit, t, float("inf"))
    kt = tm.amin(dim=1)
    lane = torch.arange(LANES, dtype=torch.int32, device=o.device)
    kl = torch.where(hit & (tm == kt[:, None]), lane, LANES).amin(dim=1)
    return kt, kl


def _chunk_plain(flat, t_lim, act, bounds_oct, tris, perm, cl_map, inst_woop):
    """One flat pool (or one chunk of a partitioned one): per ray the nearest
    hit below t_lim as (t, cluster * 128 + lane), (+inf, -1) when none."""
    dev = flat.device
    Cp = bounds_oct.shape[2]
    # boxes in true-cluster order (every octant holds the same boxes)
    bounds = torch.empty((8, Cp), dtype=torch.float32, device=dev)
    bounds[:, perm[0].long()] = bounds_oct[0]
    # padded clusters are 1e30 point boxes that no ray enters: skip them
    real = torch.nonzero(bounds[0] < 1e29).flatten()
    bounds = bounds[:, real]
    out_t = torch.full((flat.shape[0],), float("inf"), dtype=torch.float32,
                       device=dev)
    out_s = torch.full((flat.shape[0],), -1, dtype=torch.int32, device=dev)
    live = torch.nonzero(act).flatten()  # dead rays enter no box
    N, C = live.numel(), real.numel()
    if N == 0 or C == 0:
        return out_t, out_s
    flat, t_lim = flat[live], t_lim[live]
    best_t = torch.full((N,), float("inf"), dtype=torch.float32, device=dev)
    best_s = torch.full((N,), -1, dtype=torch.int32, device=dev)
    none = torch.iinfo(torch.int32).max
    step = max(1, _TWIN_STEP_ELEMS // C)
    pairs = _TWIN_STEP_ELEMS // (2 * LANES)
    for s in range(0, N, step):
        e = min(s + step, N)
        box = slab_enters(flat[s:e, 0:3], safe_inv(flat[s:e, 3:6]), bounds,
                          t_lim[s:e])
        # (ray, cluster) pairs in ray-major, cluster-minor order
        r_all, j_all = torch.nonzero(box, as_tuple=True)
        r_all = r_all + s
        c_all = real[j_all]
        for q in range(0, r_all.numel(), pairs):
            r, c = r_all[q:q + pairs], c_all[q:q + pairs]
            o, d = flat[r, 0:3], flat[r, 3:6]
            blk = c
            if cl_map is not None:
                # into the instance's mesh-local space: [o 1] A^T, [d 0] A^T
                # in the kernel's association, d left unnormalized
                blk = cl_map[0, c].long()
                a = inst_woop[cl_map[1, c].long()]  # (K, 4, 4) A^T
                o = torch.stack([o[:, 0] * a[:, 0, k] + o[:, 1] * a[:, 1, k]
                                 + o[:, 2] * a[:, 2, k] + a[:, 3, k]
                                 for k in range(3)], dim=1)
                d = torch.stack([d[:, 0] * a[:, 0, k] + d[:, 1] * a[:, 1, k]
                                 + d[:, 2] * a[:, 2, k]
                                 for k in range(3)], dim=1)
            kt, kl = _pairs_mt(o, d, t_lim[r], tris[blk])
            ks = (c * LANES).to(torch.int32) + kl
            # nearest per ray; equal t keeps the lowest cluster and lane
            new_t = best_t.scatter_reduce(0, r, kt, "amin")
            won = new_t < best_t
            cand = won[r] & (kt == new_t[r])
            new_s = torch.full_like(best_s, none).scatter_reduce(
                0, r, torch.where(cand, ks, none), "amin")
            best_s = torch.where(won, new_s, best_s)
            best_t = new_t
    out_t[live] = best_t
    out_s[live] = best_s
    return out_t, out_s


def cluster_traverse_plain(rays, cbl_oct, tris, perm, any_hit_mode: bool = False,
                           cl_map=None, inst_woop=None):
    """Plain PyTorch twin of B1/B2/B3 with the kernel's contract. Per chunk:
    a dense masked slab test of every ray against every cluster box, then
    the Woop Moller-Trumbore of every (ray, entered cluster) pair over the
    cluster's 128 lanes (padded lanes never hit); an instance-cluster's
    rays are first moved into its mesh-local space. Chunks are walked in
    order with each ray's best t as the next chunk's limit, and in any-hit
    mode an occluded ray is retired for the later chunks (the JAX package's
    _partitioned_traverse). Ties between equal t go to the lowest chunk,
    cluster and lane (the kernel: first in visit order)."""
    G, RB, _ = rays.shape
    flat = rays.reshape(-1, 8)
    if cbl_oct.dim() == 3:
        cbl_oct, tris, perm = cbl_oct[None], tris[None], perm[None]
    Cp = cbl_oct.shape[-1]
    act = flat[:, 7] > 0.0
    t0 = torch.where(act, torch.clamp(flat[:, 6], max=BIG),
                     torch.full_like(flat[:, 6], -BIG))
    t_cur = t0
    slot = torch.full_like(act, -1, dtype=torch.int32)
    for p in range(cbl_oct.shape[0]):
        kt, ks = _chunk_plain(flat, t_cur, act, cbl_oct[p],
                              tris[0] if cl_map is not None else tris[p],
                              perm[p], cl_map, inst_woop)
        found = ks >= 0
        t_cur = torch.where(found, kt, t_cur)
        slot = torch.where(found, ks + p * Cp * LANES, slot)
        if any_hit_mode:
            act = act & ~found
    if any_hit_mode:
        t_cur = torch.where(slot >= 0, -BIG, t0)
    return t_cur.reshape(G, RB), slot.reshape(G, RB)


def _to_blocks(ro, rd, t_max, active, r_blk):
    """Pack rays into (G, r_blk, 8) [o d t_lim active]; the padded tail of
    the last block is inactive."""
    R = ro.shape[0]
    Rp = max((R + r_blk - 1) // r_blk, 1) * r_blk
    r = torch.zeros((Rp, 8), dtype=torch.float32, device=ro.device)
    r[:R, 0:3] = ro
    r[:R, 3:6] = rd
    r[:R, 6] = torch.as_tensor(t_max, dtype=torch.float32, device=ro.device)
    r[:R, 7] = 1.0 if active is None else active.to(torch.float32)
    return r.reshape(Rp // r_blk, r_blk, 8), R


def local_rays(scene, inst, ray_o, ray_d):
    """Per-ray transform into instance-local space: one (R, 32) inst_attr
    row gather (rows [12:24) hold invM 3x4 row-major); directions stay
    unnormalized, so t is the world ray parameter."""
    im = scene.inst_attr[torch.clamp(inst.long(), 0,
                                     scene.inst_attr.shape[0] - 1)]
    ro = torch.stack([
        im[:, 12] * ray_o[:, 0] + im[:, 13] * ray_o[:, 1]
        + im[:, 14] * ray_o[:, 2] + im[:, 15],
        im[:, 16] * ray_o[:, 0] + im[:, 17] * ray_o[:, 1]
        + im[:, 18] * ray_o[:, 2] + im[:, 19],
        im[:, 20] * ray_o[:, 0] + im[:, 21] * ray_o[:, 1]
        + im[:, 22] * ray_o[:, 2] + im[:, 23]], dim=1)
    rd = torch.stack([
        im[:, 12] * ray_d[:, 0] + im[:, 13] * ray_d[:, 1]
        + im[:, 14] * ray_d[:, 2],
        im[:, 16] * ray_d[:, 0] + im[:, 17] * ray_d[:, 1]
        + im[:, 18] * ray_d[:, 2],
        im[:, 20] * ray_d[:, 0] + im[:, 21] * ray_d[:, 1]
        + im[:, 22] * ray_d[:, 2]], dim=1)
    return ro, rd


def scene_pool(scene, opaque_only: bool = False) -> dict:
    """The pool arguments of cluster_traverse held by `scene`, with the
    upper level of its kernel's two-level walk (cl_map and inst_woop are
    None but for an instanced pool). With opaque_only the Woop blocks are
    the opaque shadow pool cl_tris_shadow of an alpha scene: the same
    clusters with the alpha lanes zeroed, so the boxes and the level of
    cl_tris still bound every lane that can hit; the dict then also holds
    opaque_pool=True, so the launches count as B2 over that pool."""
    pool = dict(cbl_oct=scene.cl_bounds_oct,
                tris=scene.cl_tris_shadow if opaque_only else scene.cl_tris,
                perm=scene.cl_oct_perm, cl_map=scene.cl_map,
                inst_woop=scene.inst_woop,
                **{k: getattr(scene, k) for k in LEVEL_TABLES})
    if opaque_only:
        pool["opaque_pool"] = True
    return pool


def closest_hit(scene, ray_o, ray_d, t_max=1e30, active=None,
                kind: str = "primary"):
    """Returns (t, tri_id, u, v); t = +inf and tri_id = -1 on a miss. The
    kernel's slot maps to a triangle through cl_slot_tri2; the exact
    (t, u, v) come from one gathered Moller-Trumbore per ray (mt_refine),
    as in the JAX package's epilogue. Instanced scenes refine in
    mesh-local space and return the SLOT id in place of tri_id (still -1
    on a miss); compute_hit resolves it to (mesh triangle, instance)."""
    r_blk = R_BLK_BOUNCE if kind == "bounce" else R_BLK
    rays, R = _to_blocks(ray_o, ray_d, t_max, active, r_blk)
    _, slot = cluster_traverse(rays, **scene_pool(scene))
    slot = slot.reshape(-1)[:R].long()
    hit = slot >= 0
    n_slots = scene.cl_slot_tri2.shape[0]
    row = scene.cl_slot_tri2[torch.clamp(slot, 0, n_slots - 1)]
    tri = torch.where(hit, row[:, 0].long(), -1)
    tid = torch.clamp(tri, 0, scene.tri_attr.shape[0] - 1)
    a = scene.tri_attr[tid]
    v0, e1, e2 = a[:, 0:3], a[:, 3:6], a[:, 6:9]
    inst = scene.cl_map is not None
    if inst:
        ray_o, ray_d = local_rays(scene, row[:, 1], ray_o, ray_d)
    t_e, u, v = mt_refine(ray_o, ray_d, v0, e1, e2, f64=want_double(scene))
    t = torch.where(hit, t_e, float("inf"))
    if inst:
        tri = torch.where(hit, slot, -1)
    return t, tri, torch.where(hit, u, 0.0), torch.where(hit, v, 0.0)


def any_hit(scene, ray_o, ray_d, t_max, active=None, opaque_only=False,
            ao_probes=False):
    """Shadow query: True where some triangle lies in (1e-5, t_max). With
    opaque_only the walk runs over the opaque shadow pool (scene_pool), so
    alpha surfaces never occlude here. ao_probes only picks the counter
    (cluster_traverse)."""
    rays, R = _to_blocks(ray_o, ray_d, t_max, active, R_BLK)
    _, slot = cluster_traverse(rays, any_hit_mode=True, ao_probes=ao_probes,
                               **scene_pool(scene, opaque_only))
    return slot.reshape(-1)[:R] >= 0
