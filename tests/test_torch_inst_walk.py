"""The instance level, the upper level of kernel B3's two-level walk
(hydracore_tpu_torch/bvh/instanced.py:instance_tables), on a small
instanced SceneDesc: a ground plane (flattened into the world instance),
ten rotated, non-uniformly scaled instances of a 1,200-triangle blob (one
mirrored) and two boxes, built for both packages from the same numpy data.

  * the tables: lvl_members[o] is a permutation of the real
    instance-clusters, grouped by lvl_start and front-to-back within each
    group; lvl_member_bounds is cl_bounds in that order; lvl_bounds is the
    union of each instance's cluster boxes; no flat order (lvl_oct_perm
    (8, 0): B3 walks the tree);
  * the tree over the instances that kernel B3 walks (lvl_nodes,
    lvl_node_bounds): every instance with a cluster a leaf exactly once and
    every other node a child once; each node's box the union of its
    children's, bit for bit; each octant's children front to back; its
    stack within the kernel's; the same on synthetic levels of one
    instance, counts that are no power of the fan, deep trees, instances
    without a cluster, and instances that share one box (a tree of depth
    log4, not a chain, also through assemble);
  * the cull is exact: on 65,536+ float32 rays (axis-parallel directions,
    origins inside instance boxes, rays grazing box faces) every
    instance-cluster box a ray enters, in the kernels' slab arithmetic,
    lies in an instance whose box it enters, and every node or instance
    box it enters in a node whose box it enters;
  * scene_from_arrays over the JAX package's instanced arrays derives the
    same tables as assemble (bit for bit);
  * the walk counts of walk_counts (the tree walk) against a direct
    recursive count, and the wrapper's checks of the instance level.
"""
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from hydracore_tpu.scene import scene as jscene
from hydracore_tpu_torch.bvh.instanced import (TREE_FAN, TREE_STACK,
                                               instance_tables, tree_stack)
from hydracore_tpu_torch.ops import traverse_cluster as tc
from hydracore_tpu_torch.ops.intersect import safe_inv
from hydracore_tpu_torch.scene import scene as pscene
from tests.test_torch_assemble import (JAX, MAT_XML, PORT, SKY_XML,
                                       box_arrays, plane_arrays, xform)
from tests.test_torch_scene import to_port

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)


def _blob(rng, n=1200):
    c = rng.uniform(-1, 1, (n, 1, 3)).astype(np.float32)
    v = (c + rng.uniform(-0.12, 0.12, (n, 3, 3)).astype(np.float32))
    V = 3 * n
    pos = np.concatenate([v.reshape(-1, 3), np.ones((V, 1), np.float32)], 1)
    return dict(pos=pos, norm=np.tile(np.array([[0, 1, 0, 0]], np.float32), (V, 1)),
                tang=np.tile(np.array([[1, 0, 0, 0]], np.float32), (V, 1)),
                texcoord=np.zeros((V, 2), np.float32),
                indices=np.arange(V, dtype=np.int32).reshape(n, 3),
                mat_indices=np.zeros(n, np.int32))


def _desc(pkg):
    sf, vs = pkg
    rng = np.random.default_rng(5)
    meshes = {1: vs.MeshData(**plane_arrays()), 2: vs.MeshData(**box_arrays()),
              3: vs.MeshData(**_blob(rng))}
    instances = [sf.InstanceDesc(mesh_id=1, matrix=xform(0, -1.0, 0))]
    for k in range(10):
        a, b = rng.uniform(0, 2 * np.pi, 2)
        ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]])
        rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                       [0, np.sin(b), np.cos(b)]])
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = ry @ rx @ np.diag(rng.uniform(0.4, 1.2, 3))
        if k == 0:
            M[:3, 0] *= -1.0  # mirrored: negative determinant
        M[:3, 3] = rng.uniform([-6, 0, -6], [6, 3, 6])
        instances.append(sf.InstanceDesc(mesh_id=3, matrix=M))
    for tx, tz in ((-7.0, 7.0), (7.0, -7.0)):
        instances.append(sf.InstanceDesc(mesh_id=2, matrix=xform(tx, 0.0, tz)))
    cam = sf.CameraDesc()
    cam.position = np.array([0, 4, 14], np.float32)
    cam.look_at = np.array([0, 0, 0], np.float32)
    return sf.SceneDesc(
        lib_dir="", textures={}, camera=cam,
        materials={k: ET.fromstring(MAT_XML[k]) for k in (0, 1)},
        lights={0: ET.fromstring(SKY_XML)},
        settings=sf.RenderSettings(width=16, height=16, trace_depth=3),
        meshes=meshes, mesh_light_id={}, instances=instances,
        light_instances=[])


@pytest.fixture(scope="module")
def scene():
    sc = pscene.assemble(_desc(PORT), instancing="force")
    assert sc.settings.has_inst and sc.inst_woop.shape[0] == 13
    return sc


def _real(sc):
    return torch.nonzero(sc.cl_bounds[0] < 1e29).flatten()


def test_tables_group_instance_clusters(scene):
    sc = scene
    real = _real(sc)
    I, Ci = sc.inst_woop.shape[0], sc.cl_map.shape[1]
    start = sc.lvl_start.long()
    sizes = start[1:] - start[:-1]
    assert start[0] == 0 and int(start[-1]) == real.numel() and (sizes >= 0).all()
    inst_of = sc.cl_map[1].long()
    assert torch.equal(sizes, torch.bincount(inst_of[real], minlength=I))
    assert int(sizes[1:11].min()) >= 8  # each blob instance: several clusters
    for o in range(8):
        ids = sc.lvl_members[o].long()
        assert torch.equal(ids[:real.numel()].sort().values, real)
        assert not bool((sc.cl_bounds[0, ids[real.numel():]] < 1e29).any())
        # the octant's position of each cluster in the single-level order
        rank = torch.empty(Ci, dtype=torch.long)
        rank[sc.cl_oct_perm[o].long()] = torch.arange(Ci)
        for i in range(I):
            grp = ids[start[i]:start[i + 1]]
            assert (inst_of[grp] == i).all()
            assert (rank[grp].diff() > 0).all()  # front to back
        assert torch.equal(sc.lvl_member_bounds[o], sc.cl_bounds[:, ids])
    # no flat order of the instances: B3 walks the tree (its children front
    # to back: test_tree_holds_every_instance_once)
    assert tuple(sc.lvl_oct_perm.shape) == (8, 0)
    assert sc.lvl_oct_perm.dtype == torch.int32
    for i in range(I):
        grp = real[inst_of[real] == i]
        if grp.numel():
            b = sc.cl_bounds[:, grp]
            assert torch.equal(sc.lvl_bounds[0:3, i], b[0:3].amin(1))
            assert torch.equal(sc.lvl_bounds[3:6, i], b[3:6].amax(1))
    assert (sc.lvl_bounds[6:] == 0).all()


def _tree_parts(tabs, I):
    """(children (8, Nn, TREE_FAN) int64, node boxes (8, Nn)) of a level."""
    nb = torch.as_tensor(tabs["lvl_node_bounds"])
    Nn = nb.shape[1]
    kids = torch.as_tensor(tabs["lvl_nodes"]).long().reshape(8, Nn, -1)
    return kids, nb


def _check_tree(tabs, I):
    """The tree of a level: leaves and nodes each below one parent, boxes
    the exact unions, children front to back, the stack bounded."""
    kids, nb = _tree_parts(tabs, I)
    Nn = nb.shape[1]
    ib = torch.as_tensor(tabs["lvl_bounds"])
    has = ib[0] < 1e29
    assert kids.shape[2] == TREE_FAN and Nn >= 1
    for o in range(8):
        real = kids[o][kids[o] >= 0]
        # every instance with a cluster once, every node but the root once
        want = torch.cat([torch.nonzero(has).flatten(),
                          I + torch.arange(1, Nn)])
        assert torch.equal(real.sort().values, want)
        # the same children in every octant, the empty slots last
        assert torch.equal(kids[o].sort(dim=1).values, kids[0].sort(dim=1).values)
        assert not bool(((kids[o][:, :-1] < 0) & (kids[o][:, 1:] >= 0)).any())
        s = torch.tensor([1.0 if o & b else -1.0 for b in (1, 2, 4)],
                         dtype=torch.float64)
        every = torch.cat([ib, nb], dim=1)
        ctr = (every[0:3] + every[3:6]) * 0.5
        key = (s[:, None] * ctr.double()).sum(0)
        k = torch.where(kids[o] >= 0, key[kids[o].clamp(min=0)], float("inf"))
        assert bool((k[:, :-1] <= k[:, 1:]).all())
    # each node's box the union of its children's, bit for bit
    every = torch.cat([ib, nb], dim=1)
    for j in range(Nn):
        c = kids[0, j][kids[0, j] >= 0]
        if c.numel():
            assert torch.equal(nb[0:3, j], every[0:3, c].amin(1))
            assert torch.equal(nb[3:6, j], every[3:6, c].amax(1))
        else:  # no instance at all: the far point box
            assert (nb[0:6, j] == 1e30).all()
    assert (nb[6:] == 0).all()
    assert tree_stack(kids[0].numpy(), I) <= TREE_STACK
    return kids, nb


def test_tree_holds_every_instance_once(scene):
    sc = scene
    I = sc.inst_woop.shape[0]
    tabs = {k: getattr(sc, k) for k in tc.LEVEL_TABLES}
    kids, nb = _check_tree(tabs, I)
    assert nb.shape[1] > 1  # 13 instances: a root and nodes below it
    # node 0 is the root: its box holds every instance's
    assert torch.equal(nb[0:3, 0], sc.lvl_bounds[0:3].amin(1))
    assert torch.equal(nb[3:6, 0], sc.lvl_bounds[3:6].amax(1))


def _synthetic(n_inst, empty=(), per=3, seed=0, same=0):
    """Instance-cluster tables of n_inst instances of `per` random cluster
    boxes each (none for the instances in `empty`), padded to 128; the
    first `same` instances hold the same boxes (one mesh placed many times
    by one matrix)."""
    rng = np.random.default_rng(seed)
    inst = np.repeat(np.asarray([i for i in range(n_inst) if i not in empty],
                                np.int64), per)
    Ci = inst.size
    Cip = max(-(-Ci // 128) * 128, 128)
    ctr = rng.uniform(-10, 10, (n_inst, 3))[inst] + rng.normal(0, 0.3, (Ci, 3))
    ext = rng.uniform(0.01, 0.5, (Ci, 3))
    dup = inst < same
    ctr[dup] = np.tile(ctr[:per], (-(-int(dup.sum()) // per), 1))[:dup.sum()]
    ext[dup] = np.tile(ext[:per], (-(-int(dup.sum()) // per), 1))[:dup.sum()]
    b = np.zeros((8, Cip), np.float32)
    b[0:6] = 1e30
    b[0:3, :Ci], b[3:6, :Ci] = (ctr - ext).T, (ctr + ext).T
    cl_map = np.zeros((2, Cip), np.int32)
    cl_map[1, :Ci] = inst
    perm = np.stack([np.argsort(np.where(b[0] < 1e29, (b[0:3] * (o + 1)).sum(0),
                                         np.inf), kind="stable")
                     for o in range(8)]).astype(np.int32)
    return b, perm, cl_map


@pytest.mark.parametrize("n_inst,empty,same", [
    (1, (), 0), (3, (), 0), (4, (), 0), (5, (), 0), (17, (), 0), (67, (), 0),
    (300, (), 0), (6, (0, 4), 0), (40, (7, 8, 39), 0), (3, (0, 1, 2), 0),
    (1000, (), 0), (3000, (), 0), (200, (), 200), (300, (), 150)])
def test_tree_edge_cases(n_inst, empty, same):
    """One instance, counts that are no power of the fan, deep trees,
    instances without a cluster (in no node; with none at all, a root of
    no child), instances that share one box (cut at the median: a tree of
    depth log4 of their count, not a chain that outgrows the kernel's
    stack); at most TREE_FAN instances: one node, the instances its
    children."""
    b, perm, cl_map = _synthetic(n_inst, empty, same=same)
    tabs = instance_tables(b, perm, cl_map, n_inst)
    kids, nb = _check_tree(tabs, n_inst)
    real = n_inst - len(empty)
    if real <= TREE_FAN:
        assert nb.shape[1] == 1
        assert int((kids[0, 0] >= 0).sum()) == real
    if same == n_inst:  # every box the same: depth ceil(log4(n))
        depth = -(-int(np.ceil(np.log2(n_inst))) // 2)
        assert tree_stack(kids[0].numpy(), n_inst) <= depth * (TREE_FAN - 1) + 1
    if real >= 2:  # no node of a single child
        assert bool(((kids[0] >= 0).sum(dim=1) >= 2).all())
    for i in empty:
        assert (tabs["lvl_bounds"][0:6, i] == np.float32(1e30)).all()


def test_coincident_instances_make_a_shallow_tree():
    """200 instances of one box mesh at one matrix over the ground plane,
    through assemble: their boxes share one centre, so the tree cuts them
    at the median (depth log4, not a chain), and the walk from the root
    reaches every instance a vote on each would enter: a block's members
    by walk_counts equal those of the instances its rays enter."""
    sf, vs = PORT
    desc = _desc(PORT)
    desc.meshes = {1: vs.MeshData(**plane_arrays()),
                   2: vs.MeshData(**box_arrays())}
    desc.instances = [sf.InstanceDesc(mesh_id=1, matrix=xform(0, -1.0, 0))] \
        + [sf.InstanceDesc(mesh_id=2, matrix=xform(0.5, 0.0, -0.5))
           for _ in range(200)]
    sc = pscene.assemble(desc, instancing="force")
    I = sc.inst_woop.shape[0]
    assert I == 201
    tabs = {k: getattr(sc, k) for k in tc.LEVEL_TABLES}
    kids, nb = _check_tree(tabs, I)
    # the plane and 200 boxes of depth ceil(log4(200)) = 4 below one node
    assert tree_stack(kids[0].numpy(), I) <= 5 * (TREE_FAN - 1) + 1
    o, d, t = _rays(sc, 2048, 256, 256, 512)
    act = torch.arange(o.shape[0]) % 3 != 0
    blocks, _ = tc._to_blocks(o, d, t, act, 64)
    votes, members = tc.walk_counts(blocks, tc.scene_pool(sc))
    flat = blocks.reshape(-1, 8)
    ent = tc.slab_enters(flat[:, 0:3], safe_inv(flat[:, 3:6]), sc.lvl_bounds,
                         torch.clamp(flat[:, 6], max=tc.BIG))
    ent = (ent & (flat[:, 7] > 0)[:, None]).reshape(*blocks.shape[:2], I)
    sizes = sc.lvl_start.long().diff()
    assert torch.equal(members, (ent.any(dim=1).long() * sizes).sum(dim=1))
    assert int(members.max()) >= 200  # blocks that enter every box
    assert int(votes.max()) <= I + nb.shape[1]  # each node and instance once


def test_instance_without_cluster_gets_the_far_point_box(scene):
    sc = scene
    I = sc.inst_woop.shape[0]
    tabs = instance_tables(sc.cl_bounds.numpy(), sc.cl_oct_perm.numpy(),
                           sc.cl_map.numpy(), I + 1)
    assert (tabs["lvl_bounds"][0:6, I] == np.float32(1e30)).all()
    assert I not in tabs["lvl_nodes"]  # in no node of the tree
    assert tabs["lvl_start"][-1] == tabs["lvl_start"][-2]
    for k in ("lvl_members", "lvl_member_bounds"):
        assert np.array_equal(tabs[k], getattr(sc, k).numpy())
    with pytest.raises(ValueError, match="outside"):
        instance_tables(sc.cl_bounds.numpy(), sc.cl_oct_perm.numpy(),
                        sc.cl_map.numpy(), I - 1)


def _rays(sc, n_random=32768, n_axis=8192, n_inside=8192, n_graze=16384):
    """Random rays, axis-parallel ones (components exactly 0 and below
    safe_inv's eps), rays from inside instance boxes and rays in the plane
    of a cluster box face (origin outside or on the face, direction inside
    the plane); t limits infinite, finite or short."""
    rng = np.random.default_rng(17)
    real = _real(sc).numpy()
    cb = sc.cl_bounds.numpy()[:, real]
    ib = sc.lvl_bounds.numpy()[:, 1:]
    lo, hi = cb[0:3].min(1) - 1.0, cb[3:6].max(1) + 1.0

    def unit(n):
        d = rng.normal(size=(n, 3))
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    o = [rng.uniform(lo, hi, (n_random, 3))]
    d = [unit(n_random)]
    da = unit(n_axis)
    for k in range(3):
        da[k::3, k] = 0.0
        da[k::6, (k + 1) % 3] = 0.0
    da[1::7, 2] = 1e-13
    o.append(rng.uniform(lo, hi, (n_axis, 3)))
    d.append(da)
    pick = rng.integers(0, ib.shape[1], n_inside)
    o.append(rng.uniform(ib[0:3, pick].T, ib[3:6, pick].T))
    d.append(unit(n_inside))
    # grazing: a face plane of a random cluster box, the origin on that
    # plane (a third exactly on a corner), the direction in the plane
    pick = rng.integers(0, cb.shape[1], n_graze)
    axis = rng.integers(0, 3, n_graze)
    side = rng.integers(0, 2, n_graze)
    bmin, bmax = cb[0:3, pick].T, cb[3:6, pick].T
    og = rng.uniform(bmin - 2.0, bmax + 2.0)
    face = np.where(side == 1, bmax[np.arange(n_graze), axis],
                    bmin[np.arange(n_graze), axis])
    og[np.arange(n_graze), axis] = face
    corner = np.arange(n_graze) % 3 == 0
    og[corner] = np.where(rng.integers(0, 2, (corner.sum(), 3)) == 1,
                          bmax[corner], bmin[corner])
    dg = unit(n_graze)
    dg[np.arange(n_graze), axis] = 0.0
    dg /= np.linalg.norm(dg, axis=1, keepdims=True)
    o.append(og)
    d.append(dg)
    o = torch.tensor(np.concatenate(o), dtype=torch.float32)
    d = torch.tensor(np.concatenate(d), dtype=torch.float32)
    n = o.shape[0]
    t = torch.tensor(np.select([np.arange(n) % 3 == 0, np.arange(n) % 3 == 1],
                               [1e30, rng.uniform(0.0, 4.0, n)],
                               rng.uniform(0.0, 0.05, n)), dtype=torch.float32)
    return o, d, t


def test_instance_cull_is_exact(scene):
    sc = scene
    real = _real(sc)
    inst_of = sc.cl_map[1, real].long()
    o, d, t = _rays(sc)
    assert o.shape[0] >= 65536
    inv = safe_inv(d)
    entered = missed = 0
    for s in range(0, o.shape[0], 8192):
        e = s + 8192
        cl = tc.slab_enters(o[s:e], inv[s:e], sc.cl_bounds[:, real], t[s:e])
        ins = tc.slab_enters(o[s:e], inv[s:e], sc.lvl_bounds, t[s:e])
        missed += int((cl & ~ins[:, inst_of]).sum())
        entered += int(cl.sum())
    assert missed == 0
    assert entered > 50_000


def test_tree_cull_is_exact(scene):
    """Every box of the tree (node or instance) that a ray enters lies in a
    node whose box it enters, so the walk from the root reaches every
    instance the flat vote would enter."""
    sc = scene
    I = sc.inst_woop.shape[0]
    kids, nb = _tree_parts({k: getattr(sc, k) for k in tc.LEVEL_TABLES}, I)
    node, slot = torch.nonzero(kids[0] >= 0, as_tuple=True)
    child = kids[0, node, slot]  # every (parent, child) pair
    every = torch.cat([sc.lvl_bounds, nb], dim=1)
    o, d, t = _rays(sc)
    inv = safe_inv(d)
    entered = missed = 0
    for s in range(0, o.shape[0], 8192):
        e = s + 8192
        ent = tc.slab_enters(o[s:e], inv[s:e], every, t[s:e])
        missed += int((ent[:, child] & ~ent[:, I + node]).sum())
        entered += int(ent[:, child[child < I]].sum())
    assert missed == 0
    assert entered > 20_000


def _direct_walk(r, sc):
    """(votes, members) of one block r (r_blk, 8) by a recursive walk of
    the tree from its root, every ray against its own t_lim."""
    I = sc.inst_woop.shape[0]
    kids, nb = _tree_parts({k: getattr(sc, k) for k in tc.LEVEL_TABLES}, I)
    d0 = r[0, 3:6]
    oct_ = int(d0[0] > 0) + 2 * int(d0[1] > 0) + 4 * int(d0[2] > 0)
    every = torch.cat([sc.lvl_bounds, nb], dim=1)
    ent = tc.slab_enters(r[:, 0:3], safe_inv(r[:, 3:6]), every,
                         torch.clamp(r[:, 6], max=tc.BIG)) & (r[:, 7] > 0)[:, None]
    ent = ent.any(dim=0)
    sizes = sc.lvl_start.long().diff()
    got = [0, 0]

    def visit(i):
        got[0] += 1
        if not bool(ent[i]):
            return
        if i < I:
            got[1] += int(sizes[i])
            return
        for c in kids[oct_, i - I].tolist():
            if c >= 0:
                visit(c)

    visit(I)
    return got


def test_walk_positions_count_the_entered_groups(scene):
    sc = scene
    o, d, t = _rays(sc, 2048, 256, 256, 512)
    act = torch.arange(o.shape[0]) % 5 != 0
    act[:64] = False  # a block without an active ray
    blocks, _ = tc._to_blocks(o, d, t, act, 64)
    votes, members = tc.walk_counts(blocks, tc.scene_pool(sc))
    most = votes + members
    short = torch.clamp(blocks[:, :, 6].reshape(-1), max=0.5)
    least_votes, least_members = tc.walk_counts(blocks, tc.scene_pool(sc),
                                                short)
    least = least_votes + least_members
    for g in range(blocks.shape[0]):
        assert [int(votes[g]), int(members[g])] == _direct_walk(blocks[g], sc)
    assert int(votes[0]) == 1 and int(members[0]) == 0  # fails the root
    assert (least <= most).all() and bool((least < most).any())
    assert (least_votes <= votes).all() and bool((least_votes < votes).any())
    I = sc.inst_woop.shape[0]
    Nn = sc.lvl_node_bounds.shape[1]
    # the root, every other node and instance once, and every member
    assert int(most.max()) <= 1 + (I + Nn - 1) + int(sc.lvl_start[-1])


def test_scene_from_arrays_derives_the_tables():
    """The JAX package's instanced arrays give the port the same instance
    level as its own assembly; the derived tables are no scene leaves."""
    js = jscene.assemble(_desc(JAX), instancing="force")
    ps = pscene.assemble(_desc(PORT), instancing="force")
    pj = to_port(js)
    assert set(tc.LEVEL_TABLES) == set(pscene._DERIVED)
    for k in pscene._DERIVED:
        a, b = getattr(ps, k), getattr(pj, k)
        assert a is not None and a.dtype == b.dtype and torch.equal(a, b), k
    assert not set(pscene._DERIVED) & set(pscene.scene_leaves(ps))
    assert not set(pscene._DERIVED) & set(pscene.leaf_names())


def test_wrapper_checks_the_instance_level(scene):
    sc = scene
    pool = tc.scene_pool(sc)
    rays = torch.zeros((1, 64, 8))
    for k in tc.LEVEL_TABLES:
        with pytest.raises(ValueError, match="comes whole"):
            tc.cluster_traverse(rays, **{**pool, k: None})
    # members and their boxes disagree
    with pytest.raises(ValueError, match=r"lvl_member_bounds must be \(8, 8, 64\)"):
        tc.cluster_traverse(rays, **{**pool,
                                     "lvl_members": sc.lvl_members[:, :64]})
    with pytest.raises(ValueError, match="boxes, the instances"):
        tc.cluster_traverse(rays, **{**pool,
                                     "lvl_bounds": sc.lvl_bounds[:, 1:]})
    with pytest.raises(ValueError, match=r"lvl_oct_perm must be \(8, 0\)"):
        tc.cluster_traverse(rays, **{**pool, "lvl_oct_perm": torch.zeros(
            (8, sc.lvl_bounds.shape[1]), dtype=torch.int32)})
    with pytest.raises(TypeError, match="lvl_start"):
        tc.cluster_traverse(rays, **{**pool, "lvl_start": sc.lvl_start.long()})
    # the tree: its children a node and boxes agree, and B3 needs one
    with pytest.raises(ValueError, match="lvl_nodes must be"):
        tc.cluster_traverse(rays, **{**pool,
                                     "lvl_nodes": sc.lvl_nodes[:, 1:]})
    with pytest.raises(ValueError, match="B3 walks a tree"):
        tc.cluster_traverse(rays, **{**pool,
                                     "lvl_nodes": sc.lvl_nodes[:, :0],
                                     "lvl_node_bounds": sc.lvl_node_bounds[:, :0]})
    with pytest.raises(TypeError, match="lvl_node_bounds"):
        tc.cluster_traverse(rays, **{**pool, "lvl_node_bounds":
                                     sc.lvl_node_bounds.double()})
    flat_pool = {k: pool[k] for k in ("cbl_oct", "tris", "perm")}
    with pytest.raises(ValueError, match="comes whole"):
        tc.cluster_traverse(rays, **flat_pool, lvl_bounds=sc.lvl_bounds)
