"""The instance level, the upper level of kernel B3's two-level walk
(hydracore_tpu_torch/bvh/instanced.py:instance_tables), on a small
instanced SceneDesc: a ground plane (flattened into the world instance),
ten rotated, non-uniformly scaled instances of a 1,200-triangle blob (one
mirrored) and two boxes, built for both packages from the same numpy data.

  * the tables: lvl_members[o] is a permutation of the real
    instance-clusters, grouped by lvl_start and front-to-back within each
    group; lvl_member_bounds is cl_bounds in that order; lvl_bounds is the
    union of each instance's cluster boxes; lvl_oct_perm follows the centre
    key;
  * the cull is exact: on 65,536+ float32 rays (axis-parallel directions,
    origins inside instance boxes, rays grazing box faces) every
    instance-cluster box a ray enters, in the kernels' slab arithmetic,
    lies in an instance whose box it enters;
  * scene_from_arrays over the JAX package's instanced arrays derives the
    same tables as assemble (bit for bit);
  * the walk counts of walk_positions against a direct count, and the
    wrapper's checks of the instance level.
"""
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from hydracore_tpu.scene import scene as jscene
from hydracore_tpu_torch.bvh.instanced import instance_tables
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
        # instances front to back by the centre key of the cluster order
        s = torch.tensor([1.0 if o & b else -1.0 for b in (1, 2, 4)],
                         dtype=torch.float64)
        ctr = (sc.lvl_bounds[0:3] + sc.lvl_bounds[3:6]).double() * 0.5
        key = (s[:, None] * ctr).sum(0)[sc.lvl_oct_perm[o].long()]
        assert (key.diff() >= 0).all()
    for i in range(I):
        grp = real[inst_of[real] == i]
        if grp.numel():
            b = sc.cl_bounds[:, grp]
            assert torch.equal(sc.lvl_bounds[0:3, i], b[0:3].amin(1))
            assert torch.equal(sc.lvl_bounds[3:6, i], b[3:6].amax(1))
    assert (sc.lvl_bounds[6:] == 0).all()


def test_instance_without_cluster_gets_the_far_point_box(scene):
    sc = scene
    I = sc.inst_woop.shape[0]
    tabs = instance_tables(sc.cl_bounds.numpy(), sc.cl_oct_perm.numpy(),
                           sc.cl_map.numpy(), I + 1)
    assert (tabs["lvl_bounds"][0:6, I] == np.float32(1e30)).all()
    assert (tabs["lvl_oct_perm"][:, -1] == I).all()
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


def test_walk_positions_count_the_entered_groups(scene):
    sc = scene
    o, d, t = _rays(sc, 2048, 256, 256, 512)
    act = torch.arange(o.shape[0]) % 5 != 0
    blocks, _ = tc._to_blocks(o, d, t, act, 64)
    most = tc.walk_positions(blocks, tc.scene_pool(sc))
    short = torch.clamp(blocks[:, :, 6].reshape(-1), max=0.5)
    least = tc.walk_positions(blocks, tc.scene_pool(sc), short)
    I = sc.inst_woop.shape[0]
    sizes = (sc.lvl_start[1:] - sc.lvl_start[:-1]).tolist()
    for g in range(blocks.shape[0]):
        r = blocks[g]
        ent = tc.slab_enters(r[:, 0:3], safe_inv(r[:, 3:6]), sc.lvl_bounds,
                             r[:, 6]) & (r[:, 7] > 0)[:, None]
        want = I + sum(sz for i, sz in enumerate(sizes) if bool(ent[:, i].any()))
        assert int(most[g]) == want
    assert (least <= most).all() and bool((least < most).any())
    assert int(least.min()) >= I and int(most.max()) <= I + int(sc.lvl_start[-1])


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
    with pytest.raises(ValueError, match="lvl_oct_perm must be"):
        tc.cluster_traverse(rays, **{**pool,
                                     "lvl_oct_perm": sc.lvl_oct_perm[:, 1:]})
    with pytest.raises(TypeError, match="lvl_start"):
        tc.cluster_traverse(rays, **{**pool, "lvl_start": sc.lvl_start.long()})
    flat_pool = {k: pool[k] for k in ("cbl_oct", "tris", "perm")}
    with pytest.raises(ValueError, match="comes whole"):
        tc.cluster_traverse(rays, **flat_pool, lvl_bounds=sc.lvl_bounds)
