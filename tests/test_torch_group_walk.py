"""The group level, the upper level of kernels B1/B2's two-level walk
(hydracore_tpu_torch/bvh/clusters.py:group_tables), on a cornell box holding
a sphere of 23,040 triangles: 259 clusters, partitioned at a cap of 128
into three chunks of 128, 128 and 3 real clusters (the last one ragged and
smaller than CL_GROUP), and the same pool flat. Both packages build it from
the same recipe.

  * the tables: lvl_members[o] is a permutation of the real clusters
    (padding excluded), grouped by lvl_start into runs of at most CL_GROUP
    (or the size asked for) consecutive real clusters of one chunk, each
    group front to back in its chunk's octant order; lvl_member_bounds is
    the pool's boxes in that order; lvl_bounds is the exact union of each
    group's boxes; lvl_oct_perm orders the groups of all chunks by their
    nearest cluster's centre key; every table is C-contiguous, as the
    kernel reads it. The same on synthetic pools with ragged and empty
    chunks;
  * the cull is exact: on 65,536+ float32 rays (axis-parallel directions,
    origins inside group boxes, rays grazing group and cluster box faces)
    every cluster box a ray enters, in the kernels' slab arithmetic, lies
    in a group whose box it enters;
  * scene_from_arrays over the JAX package's partitioned arrays derives the
    same tables as the port's own build (bit for bit);
  * walk_counts against a direct count, and the wrapper's checks of the
    upper level (they run on the CPU).
"""
import numpy as np
import pytest
import torch

from hydracore_tpu.scene.procedural import SceneBuilder as JaxBuilder
from hydracore_tpu_torch.bvh.clusters import CL_GROUP, group_tables
from hydracore_tpu_torch.ops import traverse_cluster as tc
from hydracore_tpu_torch.ops.intersect import safe_inv
from hydracore_tpu_torch.scene import scene as pscene
from hydracore_tpu_torch.scene.procedural import SceneBuilder as PortBuilder
from tests.test_torch_scene import to_port

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)

CAP = 128


def sphere_box(builder, **kw):
    b = builder()
    m = b.lambert([0.65, 0.65, 0.65])
    b.add_box_interior(2.0, m, m, m, b.lambert([0.7, 0.12, 0.1]),
                       b.lambert([0.12, 0.55, 0.18]))
    b.add_sphere([-0.3, -0.9, 0.0], 1.0, b.lambert([0.5, 0.5, 0.7]),
                 n_seg=160, n_ring=72)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [12.0] * 3)
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=16,
                   height=16, trace_depth=3, **kw)


@pytest.fixture(scope="module")
def scenes():
    """(the partitioned pool, the same clusters flat)."""
    part = sphere_box(PortBuilder, part_cap=CAP)
    real = (part.cl_bounds[:, 0] < 1e29).sum(1).tolist()
    assert real == [128, 128, 3] and real[-1] < CL_GROUP
    return part, sphere_box(PortBuilder)


def _chunked(bounds_lane, oct_perm):
    b, perm = torch.as_tensor(bounds_lane), torch.as_tensor(oct_perm)
    return (b[None], perm[None]) if b.dim() == 2 else (b, perm)


def _check_tables(bounds_lane, oct_perm, tabs, group=CL_GROUP):
    b, perm = _chunked(bounds_lane, oct_perm)
    P, _, Cp = b.shape
    flat = b.permute(1, 0, 2).reshape(8, P * Cp)
    real = torch.nonzero(flat[0] < 1e29).flatten()
    tabs = {k: torch.as_tensor(v) for k, v in tabs.items()}
    assert all(v.is_contiguous() for v in tabs.values())
    start = tabs["lvl_start"].long()
    Gn = start.numel() - 1
    sizes = start.diff()
    assert start[0] == 0 and int(start[-1]) == real.numel()
    assert (sizes >= 1).all() and (sizes <= group).all()
    for k, shape in (("lvl_bounds", (8, Gn)), ("lvl_oct_perm", (8, Gn)),
                     ("lvl_members", (8, real.numel())),
                     ("lvl_member_bounds", (8, 8, real.numel()))):
        assert tuple(tabs[k].shape) == shape, k
    # each chunk's real clusters, cut into runs of `group` from its first
    n_real = (b[:, 0] < 1e29).sum(1).tolist()
    want = [min(group, n - k) for n in n_real for k in range(0, n, group)]
    assert sizes.tolist() == want
    ids0 = tabs["lvl_members"][0].long()
    gb = tabs["lvl_bounds"]
    for g in range(Gn):
        grp = ids0[start[g]:start[g + 1]]
        assert (grp // Cp == grp[0] // Cp).all()  # one chunk
        pos = torch.searchsorted(real, grp.sort().values)
        assert (pos.diff() == 1).all()  # consecutive real clusters
        box = flat[:, grp]
        assert torch.equal(gb[0:3, g], box[0:3].amin(1))
        assert torch.equal(gb[3:6, g], box[3:6].amax(1))
        assert (box[0:3] >= gb[0:3, g, None]).all()
        assert (box[3:6] <= gb[3:6, g, None]).all()
    assert (gb[6:] == 0).all()
    # the centre key of the cluster order (cut_clusters'), per cluster
    ctr = ((flat[0:3] + flat[3:6]) * 0.5).numpy()
    for o in range(8):
        ids = tabs["lvl_members"][o].long()
        assert torch.equal(ids.sort().values, real)
        # the octant's position of each cluster in its chunk's order
        rank = torch.empty(P * Cp, dtype=torch.long)
        rank[(torch.arange(P)[:, None] * Cp + perm[:, o].long()).reshape(-1)] \
            = torch.arange(Cp).repeat(P)
        for g in range(Gn):
            grp = ids[start[g]:start[g + 1]]
            assert torch.equal(grp.sort().values,
                               ids0[start[g]:start[g + 1]].sort().values)
            assert (rank[grp].diff() > 0).all()  # front to back
        assert torch.equal(tabs["lvl_member_bounds"][o], flat[:, ids])
        # groups front to back by their nearest cluster's key
        order = tabs["lvl_oct_perm"][o].long()
        assert torch.equal(order.sort().values, torch.arange(Gn))
        key = np.array([1.0 if o & bit else -1.0 for bit in (1, 2, 4)]) @ ctr
        near = [key[ids0[start[g]:start[g + 1]].numpy()].min() for g in range(Gn)]
        assert (np.diff(np.asarray(near)[order.numpy()]) >= 0).all()


@pytest.mark.parametrize("kind", ["partitioned", "flat"])
def test_tables_group_the_real_clusters(scenes, kind):
    sc = scenes[0] if kind == "partitioned" else scenes[1]
    assert sc.cl_tris.dim() == (4 if kind == "partitioned" else 3)
    _check_tables(sc.cl_bounds, sc.cl_oct_perm,
                  {k: getattr(sc, k) for k in tc.LEVEL_TABLES})
    assert sc.cl_map is None


def _synthetic_pool(fills, Cp=128, seed=3):
    """Random boxes in chunks of Cp holding `fills` real clusters each, the
    rest 1e30 point boxes; each chunk's octant order by the centre key,
    padding last (as partition_clusters lays a pool out)."""
    rng = np.random.default_rng(seed)
    P = len(fills)
    bl = np.zeros((P, 8, Cp), np.float32)
    bl[:, 0:6] = 1e30
    perm = np.zeros((P, 8, Cp), np.int32)
    for p, n in enumerate(fills):
        lo = rng.uniform(-5, 5, (3, n)).astype(np.float32)
        bl[p, 0:3, :n] = lo
        bl[p, 3:6, :n] = lo + rng.uniform(0, 1, (3, n)).astype(np.float32)
        ctr = (bl[p, 0:3] + bl[p, 3:6]) * 0.5
        for o in range(8):
            s = np.array([1.0 if o & bit else -1.0 for bit in (1, 2, 4)])
            key = s @ ctr
            key[n:] = np.inf
            perm[p, o] = np.argsort(key, kind="stable")
    return bl, perm


@pytest.mark.parametrize("fills", [(128, 37, 5, 0, 20), (200,), (0,)])
def test_tables_of_ragged_and_empty_chunks(fills):
    bl, perm = _synthetic_pool(fills, Cp=256 if fills == (200,) else 128)
    if len(fills) == 1:
        bl, perm = bl[0], perm[0]
    tabs = group_tables(bl, perm)
    assert tabs["lvl_start"].dtype == np.int32
    assert tabs["lvl_oct_perm"].dtype == np.int32
    assert tabs["lvl_members"].dtype == np.int32
    assert tabs["lvl_bounds"].dtype == np.float32
    _check_tables(bl, perm, tabs)
    Gn = sum(-(-n // CL_GROUP) for n in fills)
    assert tabs["lvl_bounds"].shape == (8, Gn)


@pytest.mark.parametrize("group", [1, 16, 32])
def test_tables_of_other_group_sizes(scenes, group):
    """The sizes chip_smoke.py times beside CL_GROUP, and groups of one
    cluster: the same tables, cut into runs of `group`."""
    sc = scenes[0]
    tabs = group_tables(sc.cl_bounds, sc.cl_oct_perm, group)
    _check_tables(sc.cl_bounds, sc.cl_oct_perm, tabs, group)
    n_real = (sc.cl_bounds[:, 0] < 1e29).sum(1).tolist()
    assert tabs["lvl_bounds"].shape[1] == sum(-(-n // group) for n in n_real)


def _rays(sc, n_random=24576, n_axis=8192, n_inside=8192, n_graze=24576):
    """Random rays, axis-parallel ones (components exactly 0 and below
    safe_inv's eps), rays from inside group boxes and rays in the plane of
    a group box face (the first half) or a cluster box face (the second),
    the origin outside or on the face (a third exactly on a corner), the
    direction inside the plane; t limits infinite, finite or short."""
    rng = np.random.default_rng(17)
    b, _ = _chunked(sc.cl_bounds, sc.cl_oct_perm)
    flat = b.permute(1, 0, 2).reshape(8, -1)
    cb = flat[:, flat[0] < 1e29].numpy()
    gb = sc.lvl_bounds.numpy()
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
    pick = rng.integers(0, gb.shape[1], n_inside)
    o.append(rng.uniform(gb[0:3, pick].T, gb[3:6, pick].T))
    d.append(unit(n_inside))
    half = n_graze // 2
    boxes = np.concatenate([gb[:, rng.integers(0, gb.shape[1], half)],
                            cb[:, rng.integers(0, cb.shape[1], n_graze - half)]],
                           axis=1)
    axis = rng.integers(0, 3, n_graze)
    side = rng.integers(0, 2, n_graze)
    bmin, bmax = boxes[0:3].T, boxes[3:6].T
    og = rng.uniform(bmin - 1.0, bmax + 1.0)
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
                               [1e30, rng.uniform(0.0, 3.0, n)],
                               rng.uniform(0.0, 0.05, n)), dtype=torch.float32)
    return o, d, t


def test_group_cull_is_exact(scenes):
    sc = scenes[0]
    b, _ = _chunked(sc.cl_bounds, sc.cl_oct_perm)
    flat = b.permute(1, 0, 2).reshape(8, -1)
    # every real cluster, in group order, and the group of each
    ids = sc.lvl_members[0].long()
    group_of = torch.repeat_interleave(torch.arange(sc.lvl_bounds.shape[1]),
                                       sc.lvl_start.long().diff())
    o, d, t = _rays(sc)
    assert o.shape[0] >= 65536
    inv = safe_inv(d)
    entered = missed = grazing = 0
    for s in range(0, o.shape[0], 8192):
        e = s + 8192
        cl = tc.slab_enters(o[s:e], inv[s:e], flat[:, ids], t[s:e])
        grp = tc.slab_enters(o[s:e], inv[s:e], sc.lvl_bounds, t[s:e])
        missed += int((cl & ~grp[:, group_of]).sum())
        entered += int(cl.sum())
        if s >= o.shape[0] - 24576:
            grazing += int(cl.sum())
    assert missed == 0
    assert entered > 50_000 and grazing > 1_000


def test_scene_from_arrays_derives_the_tables(scenes):
    """The JAX package's partitioned arrays give the port the same group
    level as its own build; the derived tables are no scene leaves."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HYDRA_CL_PART_CAP", str(CAP))
    try:
        js = sphere_box(JaxBuilder)
    finally:
        mp.undo()
    ps = scenes[0]
    pj = to_port(js)
    assert pj.cl_tris.dim() == 4 and pj.cl_tris.shape[0] == 3
    assert pj.cl_map is None
    for k in tc.LEVEL_TABLES:
        a, b = getattr(ps, k), getattr(pj, k)
        assert a is not None and a.dtype == b.dtype and torch.equal(a, b), k
    assert not set(pscene._DERIVED) & set(pscene.scene_leaves(ps))


def test_walk_positions_count_the_entered_groups(scenes):
    sc = scenes[0]
    pool = tc.scene_pool(sc)
    o, d, t = _rays(sc, 2048, 256, 256, 512)
    act = torch.arange(o.shape[0]) % 5 != 0
    blocks, _ = tc._to_blocks(o, d, t, act, 64)
    most = sum(tc.walk_counts(blocks, pool))  # votes + members
    short = torch.clamp(blocks[:, :, 6].reshape(-1), max=0.5)
    least = sum(tc.walk_counts(blocks, pool, short))
    Gn = sc.lvl_bounds.shape[1]
    sizes = sc.lvl_start.long().diff().tolist()
    for g in range(blocks.shape[0]):
        r = blocks[g]
        ent = tc.slab_enters(r[:, 0:3], safe_inv(r[:, 3:6]), sc.lvl_bounds,
                             r[:, 6]) & (r[:, 7] > 0)[:, None]
        want = Gn + sum(sz for i, sz in enumerate(sizes) if bool(ent[:, i].any()))
        assert int(most[g]) == want
    assert (least <= most).all() and bool((least < most).any())
    assert int(least.min()) >= Gn and int(most.max()) <= Gn + int(sc.lvl_start[-1])


def test_wrapper_checks_the_group_level(scenes):
    sc = scenes[0]
    pool = tc.scene_pool(sc)
    assert set(tc.LEVEL_TABLES) <= set(pool) and pool["cl_map"] is None
    o, d, t = _rays(sc, 256, 0, 0, 0)
    rays, _ = tc._to_blocks(o, d, t, None, 64)
    for k in tc.LEVEL_TABLES:
        with pytest.raises(ValueError, match="comes whole"):
            tc.cluster_traverse(rays, **{**pool, k: None})
    with pytest.raises(ValueError, match="lvl_members must be"):
        tc.cluster_traverse(rays, **{**pool, "lvl_members": sc.lvl_members[:4]})
    with pytest.raises(ValueError, match="lvl_member_bounds must be"):
        tc.cluster_traverse(rays, **{**pool, "lvl_member_bounds":
                                     sc.lvl_member_bounds[:, :, 1:]})
    with pytest.raises(ValueError, match="lvl_oct_perm must be"):
        tc.cluster_traverse(rays, **{**pool,
                                     "lvl_oct_perm": sc.lvl_oct_perm[:, 1:]})
    with pytest.raises(ValueError, match="lvl_start must be"):
        tc.cluster_traverse(rays, **{**pool, "lvl_start": sc.lvl_start[1:]})
    with pytest.raises(TypeError, match="lvl_start"):
        tc.cluster_traverse(rays, **{**pool, "lvl_start": sc.lvl_start.long()})
    with pytest.raises(TypeError, match="lvl_bounds"):
        tc.cluster_traverse(rays, **{**pool,
                                     "lvl_bounds": sc.lvl_bounds.double()})
    flat_pool = tc.scene_pool(scenes[1])
    with pytest.raises(ValueError, match="holds 259 clusters, the pool 256"):
        tc.cluster_traverse(rays, **{**pool, "lvl_members": torch.zeros(
            (8, 259), dtype=torch.int32),
            "lvl_member_bounds": torch.zeros((8, 8, 259)),
            "cbl_oct": pool["cbl_oct"][:2], "tris": pool["tris"][:2],
            "perm": pool["perm"][:2]})
    # a group level with cl_map: B3 reads an instance per upper box
    with pytest.raises(ValueError, match="boxes, the instances 1"):
        tc.cluster_traverse(rays, **{**flat_pool, "cl_map": torch.zeros(
            (2, 384), dtype=torch.int32), "inst_woop": torch.zeros((1, 4, 4))})
    # the twin (CPU tensors) reads cbl_oct and perm, the kernel only the level
    with pytest.raises(ValueError, match="come together"):
        tc.cluster_traverse(rays, **{**pool, "perm": None})
    with pytest.raises(ValueError, match="needs cbl_oct and perm"):
        tc.cluster_traverse(rays, **{**pool, "cbl_oct": None, "perm": None})
    # the plain twin on the CPU: the same answer with or without the level
    twin = {k: pool[k] for k in ("cbl_oct", "tris", "perm")}
    t_a, s_a = tc.cluster_traverse(rays, **pool)
    t_b, s_b = tc.cluster_traverse(rays, **twin)
    assert torch.equal(t_a, t_b) and torch.equal(s_a, s_b)
    assert int((s_a >= 0).sum()) > 50
