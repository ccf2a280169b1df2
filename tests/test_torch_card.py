"""Tests of the port that need an NVIDIA GPU: kernels B1/B2 (flat and
partitioned pools, a two-level walk over groups of clusters; B2 also over
the opaque shadow pool of an alpha scene), B3
(instanced pools: a walk of the tree over the instances, whose vote counter
reads 1 a dead block and lies between the twin's least and most on the
sphereflake) and B4 (warp packets over the
8-wide BVH; B2 also on the path tracer's AO probes) against their plain
twins, the path tracer on the card against the CPU twins, by the cluster
and by the packet route (SSS, fog and AO-dirt materials too), the render
layers' sum, light tracing and the G-buffer (and adaptive sampling and
the numpy oracle on a scene that lies on the card), bidirectional path
tracing strategy by strategy, one Metropolis step of PSSMLT and of MMLT
from a shared chain state, and the
kernel lab's kernels T1-T7 (hydracore_tpu_torch/tools/) against their
plain versions on the card (T1-T7 also on their tools' adversarial_inputs;
T3, T4 and T5 also in their profiling builds), the spans of
utils/spans.py on the profiler's clock (a kernel's launch inside its span,
a sync counted at its line), and the dense route's kernel
(csrc/traverse_dense.cu) against its plain version in float32 and float64
on tests/dense_cases.py's adversarial case, the benchmark's Cornell
box and a scene above BLOCK_SLOTS, one launch and no host sync a call.

Each test skips without CUDA. The file imports nothing of the JAX package,
so it runs on a machine with the card:

    python -m pytest tests/test_torch_card.py -q

Tolerances: kernel and twin (or plain version) share their arithmetic (no fast math, no FMA
contraction) and, for B4, their packet size and walk order, so t, u, v,
slots, occlusion and visit counts must be equal; the card's image must
agree with the CPU twins' image within 1e-3 on >= 99% of pixels. The lab
kernels round every operation as their plain versions do (separate
multiplies and adds, IEEE division), so their outputs must be equal.
"""
import dataclasses
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from hydracore_tpu_torch.integrators import (bdpt, gbuffer, lt, mlt, mmlt,
                                            oracle, pt)
from hydracore_tpu_torch.ops import traverse_cluster as tc
from hydracore_tpu_torch.ops import traverse_packet as tp
from hydracore_tpu_torch.scene import statefile as sf
from hydracore_tpu_torch.scene.procedural import SceneBuilder
from hydracore_tpu_torch.scene.scene import assemble, finalize_scene
from hydracore_tpu_torch.scene.textures import TextureStorage
from hydracore_tpu_torch.scene.vsgf import MeshData
from hydracore_tpu_torch.tools import bench_pallas_gather as t7
from hydracore_tpu_torch.tools import exp_kernel_cost as t1
from hydracore_tpu_torch.tools import proto_cluster as t2
from hydracore_tpu_torch.tools import proto_packet as t3
from hydracore_tpu_torch.tools import proto_packet2 as t4
from hydracore_tpu_torch.tools import proto_prims as t6
from hydracore_tpu_torch.tools import proto_subvisit as t5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    return torch.device("cuda")


def _rects_scene(n: int = 350, part_cap: int = 1024, traversal: str = "auto"):
    """tests/test_traverse_cluster.py's 350 random rects; 30,000 of them
    make a pool of several 128-cluster chunks."""
    rng = np.random.default_rng(7)
    b = SceneBuilder()
    m = b.lambert([0.7, 0.7, 0.7])
    for _ in range(n):
        b.add_rect(rng.uniform(-4, 4, 3), rng.uniform(-0.4, 0.4, 3),
                   rng.uniform(-0.4, 0.4, 3), m)
    return b.build(cam_pos=[0, 0, 10], cam_lookat=[0, 0, 0], width=8, height=8,
                   part_cap=part_cap, traversal=traversal)


def _instanced_scene(size: int = 32, instancing: str = "force",
                     same: int = 0):
    """40 instances (rotated, non-uniformly scaled, one mirrored) of a mesh
    of 2,000 random triangles over a ground plane, under a sky; with
    `same`, that many instances of the mesh at the identity in their
    place."""
    rng = np.random.default_rng(11)

    def mesh(v, idx, mat):
        V = len(v)
        n = np.tile(np.array([[0, 1, 0, 0]], np.float32), (V, 1))
        t = np.tile(np.array([[1, 0, 0, 0]], np.float32), (V, 1))
        return MeshData(pos=np.concatenate([v, np.ones((V, 1), np.float32)], 1),
                        norm=n, tang=t, texcoord=np.zeros((V, 2), np.float32),
                        indices=idx, mat_indices=np.full(len(idx), mat, np.int32))

    c = rng.uniform(-1, 1, (2000, 1, 3)).astype(np.float32)
    v = (c + rng.uniform(-0.15, 0.15, (2000, 3, 3)).astype(np.float32))
    blob = mesh(v.reshape(-1, 3), np.arange(6000, dtype=np.int32).reshape(-1, 3), 0)
    g = 30.0
    plane = mesh(np.array([[-g, -2, -g], [g, -2, -g], [g, -2, g], [-g, -2, g]],
                          np.float32),
                 np.asarray([(0, 2, 1), (0, 3, 2)], np.int32), 1)
    instances = [sf.InstanceDesc(mesh_id=1, matrix=np.eye(4, dtype=np.float32))]
    for k in range(40):
        a = rng.uniform(0, 2 * np.pi)
        ca, sa = np.cos(a), np.sin(a)
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]]) \
            @ np.diag(rng.uniform(0.5, 1.5, 3))
        if k == 0:
            M[:3, 0] *= -1.0
        M[:3, 3] = rng.uniform([-12, 0, -12], [12, 4, 12])
        instances.append(sf.InstanceDesc(mesh_id=2, matrix=M))
    if same:
        instances[1:] = [sf.InstanceDesc(mesh_id=2, matrix=np.eye(4, dtype=np.float32))
                         for _ in range(same)]
    mats = {k: ET.fromstring(
        f'<material id="{k}" type="hydra_material"><diffuse brdf_type="lambert">'
        f'<color val="{col}"/></diffuse></material>')
        for k, col in ((0, "0.7 0.3 0.2"), (1, "0.5 0.5 0.5"))}
    sky = ET.fromstring(
        '<light id="0" type="sky" shape="sky" distribution="uniform"><intensity>'
        '<color val="0.6 0.7 0.9"/><multiplier val="1"/></intensity></light>')
    cam = sf.CameraDesc()
    cam.position = np.array([0, 10, 34], np.float32)
    cam.look_at = np.array([0, 0, 0], np.float32)
    desc = sf.SceneDesc(
        lib_dir="", textures={}, materials=mats, lights={0: sky}, camera=cam,
        settings=sf.RenderSettings(width=size, height=size, trace_depth=3),
        meshes={1: plane, 2: blob}, mesh_light_id={}, instances=instances,
        light_instances=[])
    return assemble(desc, instancing=instancing)


def _box_scene(size: int, traversal: str = "cluster"):
    b = SceneBuilder()
    m = b.lambert([0.65, 0.65, 0.65])
    b.add_box_interior(2.0, m, m, m, b.lambert([0.7, 0.12, 0.1]),
                       b.lambert([0.12, 0.55, 0.18]))
    glass = b.add_material(transp_color=np.array([0.95] * 3, np.float32),
                           transp_gloss=1.0, transp_ior=1.5)
    b.add_sphere([0.0, -1.2, 0.5], 0.8, glass)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [12.0] * 3)
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=size,
                   height=size, trace_depth=5, traversal=traversal)


@pytest.mark.parametrize("any_hit_mode", [False, True])
@pytest.mark.parametrize("r_blk", [tc.R_BLK, tc.R_BLK_BOUNCE])
def test_kernel_matches_twin(cuda, any_hit_mode, r_blk):
    sc = _rects_scene().to(cuda)
    rng = np.random.default_rng(3)
    R = 5000  # a ragged last block
    ro = torch.tensor(rng.uniform(-6, 6, (R, 3)), dtype=torch.float32, device=cuda)
    rd = torch.tensor(rng.normal(size=(R, 3)), dtype=torch.float32, device=cuda)
    rd = rd / rd.norm(dim=1, keepdim=True)
    act = torch.tensor(np.arange(R) % 7 != 0, device=cuda)
    t_max = torch.where(torch.arange(R, device=cuda) % 3 == 0, 4.0, 1e30)
    blocks, _ = tc._to_blocks(ro, rd, t_max, act, r_blk)
    pool = (sc.cl_bounds_oct, sc.cl_tris, sc.cl_oct_perm)
    before = (tc.closest_launches, tc.any_launches)
    t_k, s_k = tc.cluster_traverse(blocks, any_hit_mode=any_hit_mode,
                                   **tc.scene_pool(sc))
    after = (tc.closest_launches, tc.any_launches)
    t_t, s_t = tc.cluster_traverse_plain(blocks, *pool,
                                         any_hit_mode=any_hit_mode)
    torch.cuda.synchronize()
    assert after[int(any_hit_mode)] == before[int(any_hit_mode)] + 1
    assert after[1 - int(any_hit_mode)] == before[1 - int(any_hit_mode)]
    assert 100 < int((s_k >= 0).sum()) < R
    assert torch.equal(s_k >= 0, s_t >= 0)
    assert torch.equal(t_k, t_t)
    if not any_hit_mode:
        assert torch.equal(s_k, s_t)


def _random_blocks(cuda, lo, hi, r_blk, t_short):
    rng = np.random.default_rng(3)
    R = 5000  # a ragged last block
    ro = torch.tensor(rng.uniform(lo, hi, (R, 3)), dtype=torch.float32, device=cuda)
    rd = torch.tensor(rng.normal(size=(R, 3)), dtype=torch.float32, device=cuda)
    rd = rd / rd.norm(dim=1, keepdim=True)
    act = torch.tensor(np.arange(R) % 7 != 0, device=cuda)
    t_max = torch.where(torch.arange(R, device=cuda) % 3 == 0, t_short, 1e30)
    return tc._to_blocks(ro, rd, t_max, act, r_blk)[0], R


@pytest.mark.parametrize("any_hit_mode", [False, True])
@pytest.mark.parametrize("r_blk", [tc.R_BLK, tc.R_BLK_BOUNCE])
def test_chunked_kernel_matches_twin_and_flat(cuda, any_hit_mode, r_blk):
    """B1/B2 over a partitioned pool: one launch walks every chunk."""
    part = _rects_scene(30000, part_cap=128).to(cuda)
    flat = _rects_scene(30000, part_cap=1024).to(cuda)
    assert part.cl_tris.dim() == 4 and part.cl_tris.shape[0] >= 3
    assert flat.cl_tris.dim() == 3
    blocks, R = _random_blocks(cuda, -5, 5, r_blk, 1.0)
    pool = (part.cl_bounds_oct, part.cl_tris, part.cl_oct_perm)
    before = (tc.closest_launches, tc.any_launches)
    t_k, s_k = tc.cluster_traverse(blocks, any_hit_mode=any_hit_mode,
                                   **tc.scene_pool(part))
    after = (tc.closest_launches, tc.any_launches)
    t_t, s_t = tc.cluster_traverse_plain(blocks, *pool,
                                         any_hit_mode=any_hit_mode)
    t_f, s_f = tc.cluster_traverse(blocks, any_hit_mode=any_hit_mode,
                                   **tc.scene_pool(flat))
    torch.cuda.synchronize()
    assert after[int(any_hit_mode)] == before[int(any_hit_mode)] + 1
    hit = s_k >= 0
    assert 100 < int(hit.sum()) < R
    assert torch.equal(hit, s_t >= 0) and torch.equal(hit, s_f >= 0)
    # kernel and twin share their arithmetic; equal t from two triangles may
    # go to either (first in visit order against lowest slot)
    assert torch.equal(t_k, t_t)
    if not any_hit_mode:
        assert float((s_k == s_t).float().mean()) >= 0.999
        assert int(s_k.max()) >= 2 * 128 * 128  # hits in the third chunk
        # against the flat kernel: another visit order, the same nearest hit
        assert float((t_k == t_f).float().mean()) >= 0.999
        tri_k = part.cl_slot_tri[s_k[hit].long()]
        tri_f = flat.cl_slot_tri[s_f[hit].long()]
        assert float((tri_k == tri_f).float().mean()) >= 0.999


def _instanced_blocks(sc, r_blk):
    """Random rays (ragged last block) and three blocks of their own: rays
    far above the scene pointing up (they enter no blob instance), rays
    from the centres of instance boxes, and rays of one octant (+x +y +z)
    whose first aims at the centre of the first blob instance that octant
    walks. Returns (blocks, valid rays, index of the aimed ray)."""
    dev = sc.cl_tris.device
    blocks, R = _random_blocks(dev, [-14, -1, -14], [14, 6, 14], r_blk, 3.0)
    rng = np.random.default_rng(21)

    def unit(n, positive=False):
        d = rng.normal(size=(n, 3))
        d = np.abs(d) if positive else d
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    ib = sc.lvl_bounds.cpu().numpy()
    ctr = (ib[0:3] + ib[3:6]).T * 0.5  # (I, 3)
    # front to back in that octant: by the sum of the box centre's x, y, z
    key = np.where(ib[0] < 1e29, np.ones(3) @ ctr.T, np.inf)
    first = next(int(i) for i in np.argsort(key, kind="stable") if i > 0)
    d_aim = unit(r_blk, positive=True)
    d_aim[0] = 1.0 / np.sqrt(3.0)
    o_aim = rng.uniform(-14, 14, (r_blk, 3))
    o_aim[:, 1] = rng.uniform(-1.5, 6, r_blk)
    o_aim[0] = ctr[first] - 2.5 * d_aim[0]
    up = np.tile([[0.0, 1.0, 0.0]], (r_blk, 1)) + 0.1 * unit(r_blk)
    sets = [(rng.uniform([-14, 40, -14], [14, 41, 14], (r_blk, 3)),
             np.abs(up) / np.linalg.norm(up, axis=1, keepdims=True)),
            (ctr[1 + np.arange(r_blk) % (ctr.shape[0] - 1)], unit(r_blk)),
            (o_aim, d_aim)]
    extra = [tc._to_blocks(torch.tensor(o, dtype=torch.float32, device=dev),
                           torch.tensor(d, dtype=torch.float32, device=dev),
                           1e30, None, r_blk)[0] for o, d in sets]
    aimed = (blocks.shape[0] + 2) * r_blk
    return torch.cat([blocks] + extra), R, aimed


@pytest.mark.parametrize("any_hit_mode", [False, True])
@pytest.mark.parametrize("r_blk", [32, 64, tc.R_BLK_BOUNCE, tc.R_BLK])
def test_instanced_kernel_matches_twin(cuda, any_hit_mode, r_blk):
    """B3: the two-level walk (instance boxes, then the entered instances'
    clusters in world space, the Woop test in each instance's local space)
    against the twin, which tests every instance-cluster: equal hit masks
    and t, slots equal on >= 99.9% (the cull changes no box test, so only
    the pick among equal t may differ), at r_blk 32 to 256."""
    sc = _instanced_scene().to(cuda)
    assert sc.settings.has_inst and sc.inst_woop.shape[0] == 41
    blocks, R, aimed = _instanced_blocks(sc, r_blk)
    pool = tc.scene_pool(sc)
    twin_pool = {k: v for k, v in pool.items() if k not in tc.LEVEL_TABLES}
    before = (tc.inst_closest_launches, tc.inst_any_launches,
              tc.closest_launches, tc.any_launches)
    t_k, s_k = tc.cluster_traverse(blocks, any_hit_mode=any_hit_mode, **pool)
    after = (tc.inst_closest_launches, tc.inst_any_launches,
             tc.closest_launches, tc.any_launches)
    t_t, s_t = tc.cluster_traverse_plain(blocks, any_hit_mode=any_hit_mode,
                                         **twin_pool)
    torch.cuda.synchronize()
    assert after[int(any_hit_mode)] == before[int(any_hit_mode)] + 1
    assert after[2:] == before[2:]
    t_k, s_k, t_t, s_t = (x.reshape(-1) for x in (t_k, s_k, t_t, s_t))
    hit = s_k >= 0
    assert 100 < int(hit[:R].sum()) < R
    up = slice(blocks.shape[0] * r_blk - 3 * r_blk, -2 * r_blk)
    assert not bool(hit[up].any())  # the block that enters no blob instance
    assert bool(hit[aimed])  # the first instance walked holds its hit
    assert torch.equal(hit, s_t >= 0)
    assert torch.equal(t_k, t_t)
    if not any_hit_mode:
        assert float((s_k[hit] == s_t[hit]).float().mean()) >= 0.999
        inst = sc.cl_slot_tri2[s_k[hit].long(), 1]
        assert int(inst.unique().numel()) > 20  # hits across the instances
        # the rays from inside the instance boxes hit their own blob
        inside = slice(blocks.shape[0] * r_blk - 2 * r_blk, -r_blk)
        assert float(hit[inside].float().mean()) > 0.5


@pytest.fixture(scope="module")
def sphereflake():
    """The benchmark's sphereflake at size factor 4 (7,381 spheres, one
    mesh instanced, and the floor), built from its configuration by
    tests/sphereflake_case.py and assembled by the port's own rules
    (CPU)."""
    from sphereflake_case import sphereflake_scene

    return sphereflake_scene()


def _flake_wavefront(sc, kind: str):
    """2^16 rays of the sphereflake: every 16th primary ray of pass 0 (in
    Morton order), or a bounce from their hits (a direction drawn about the
    geometric normal, sorted into coherence order as the port sorts its
    bounces; missed rays inactive). Returns (o, d, active, r_blk)."""
    from hydracore_tpu_torch.ops import trace_api
    from hydracore_tpu_torch.utils.math3d import offs_ray_pos

    o, d, _, _, _ = bdpt._eye_wavefront(sc, [0], 2**31 + 3)
    o, d = o[::16].contiguous(), d[::16].contiguous()
    if kind == "primary":
        return o, d, None, tc.R_BLK
    t, tri, u, v = trace_api.closest_hit(sc, o, d)
    hit = tri >= 0
    pos, _, ng, *_ = pt.compute_hit(sc, tri, u, v, o, d, t)
    ng = torch.where(((ng * d).sum(-1) > 0)[:, None], -ng, ng)
    g = torch.Generator(device=o.device).manual_seed(7)
    w = torch.randn(o.shape, generator=g, device=o.device)
    w = w / w.norm(dim=1, keepdim=True)
    w = torch.where(((w * ng).sum(-1) < 0)[:, None], -w, w)
    o = torch.where(hit[:, None], offs_ray_pos(pos, ng, w), 0.0)
    order = trace_api.coherence_order(sc, o, w, hit)
    return o[order], w[order], hit[order], tc.R_BLK_BOUNCE


@pytest.mark.parametrize("any_hit_mode", [False, True])
@pytest.mark.parametrize("kind", ["primary", "bounce"])
def test_b3_on_the_sphereflake_equals_its_twin(cuda, sphereflake, kind,
                                               any_hit_mode):
    """B3 at the benchmark's size (7,382 instances, about 59,000
    instance-clusters) on a primary and a bounce wavefront of 2^16 rays
    against the twin, which tests every instance-cluster: every t word
    equal, and every slot word in closest hit (in any hit the slot names
    whichever occluder the walk met first, so only its sign is the
    answer)."""
    sc = sphereflake.to(cuda)
    assert sc.inst_woop.shape[0] == 7382 and sc.cl_map.shape[1] > 59_000
    o, d, active, r_blk = _flake_wavefront(sc, kind)
    assert o.shape[0] == 1 << 16
    # any hit: primary rays reach the near half of the flake, bounce rays
    # their neighbours
    t_max = (3.0 if kind == "primary" else 0.3) if any_hit_mode else 1e30
    blocks, _ = tc._to_blocks(o, d, t_max, active, r_blk)
    pool = tc.scene_pool(sc)
    twin = {k: v for k, v in pool.items() if k not in tc.LEVEL_TABLES}
    before = tc.inst_any_launches if any_hit_mode else \
        tc.inst_closest_launches
    t_k, s_k = tc.cluster_traverse(blocks, any_hit_mode=any_hit_mode, **pool)
    t_t, s_t = tc.cluster_traverse_plain(blocks, any_hit_mode=any_hit_mode,
                                         **twin)
    torch.cuda.synchronize()
    after = tc.inst_any_launches if any_hit_mode else \
        tc.inst_closest_launches
    assert after == before + 1
    hits = int((s_k >= 0).sum())
    assert 1000 < hits <= o.shape[0]
    assert any_hit_mode or kind == "bounce" or hits == o.shape[0]
    assert torch.equal(t_k, t_t)
    if any_hit_mode:
        assert hits < o.shape[0]
        assert torch.equal(s_k >= 0, s_t >= 0)
    else:
        assert torch.equal(s_k, s_t)


@pytest.mark.parametrize("any_hit_mode", [False, True])
def test_b3_dead_blocks_vote_once(cuda, any_hit_mode):
    """B3 on a wavefront whose rays are all dead: every block fails the
    vote on the tree's root and leaves, one vote a block (counter
    traverse_cluster.b3_upper_votes, gathered only while spans record)."""
    from hydracore_tpu_torch.utils import spans

    sc = _instanced_scene().to(cuda)
    blocks, _, _ = _instanced_blocks(sc, tc.R_BLK)
    blocks[:, :, 7] = 0.0
    with spans.recording():
        t, s = tc.cluster_traverse(blocks, any_hit_mode=any_hit_mode,
                                   **tc.scene_pool(sc))
    got = spans.take().counters
    assert got[tc.VOTES_COUNTER] == blocks.shape[0]
    assert bool((s == -1).all()) and bool((t == -tc.BIG).all())
    tc.cluster_traverse(blocks, any_hit_mode=any_hit_mode, **tc.scene_pool(sc))
    assert tc.VOTES_COUNTER not in spans.take().counters  # not recording


@pytest.mark.parametrize("any_hit_mode", [False, True])
@pytest.mark.parametrize("kind", ["primary", "bounce"])
def test_b3_votes_on_the_sphereflake_lie_between_its_twins(
        cuda, sphereflake, kind, any_hit_mode):
    """B3's upper-level votes on the wavefronts of
    test_b3_on_the_sphereflake_equals_its_twin, counted on the card, lie
    between the tree walk's least (walk_counts against the kernel's final
    t) and most (against t_lim) over all blocks; primary blocks vote far
    less than on each of the 7,382 instances."""
    from hydracore_tpu_torch.utils import spans

    sc = sphereflake.to(cuda)
    o, d, active, r_blk = _flake_wavefront(sc, kind)
    t_max = (3.0 if kind == "primary" else 0.3) if any_hit_mode else 1e30
    blocks, _ = tc._to_blocks(o, d, t_max, active, r_blk)
    pool = tc.scene_pool(sc)
    with spans.recording():
        t_k, _ = tc.cluster_traverse(blocks, any_hit_mode=any_hit_mode, **pool)
    got = spans.take().counters[tc.VOTES_COUNTER]
    least, _ = tc.walk_counts(blocks, pool, t_k.reshape(-1))
    most, _ = tc.walk_counts(blocks, pool)
    assert int(least.sum()) <= got <= int(most.sum())
    G = blocks.shape[0]
    assert int(most.sum()) < G * 7382
    if kind == "primary":
        assert got < G * 7382 // 20


@pytest.mark.parametrize("any_hit_mode", [False, True])
def test_b3_on_coincident_instances_equals_its_twin(cuda, any_hit_mode):
    """B3 on 200 instances of one mesh at one matrix (boxes of one centre,
    which the tree cuts at the median) over the ground plane: the scene
    assembles, and every hit and t equals the twin's; a block that enters
    the boxes votes on fewer than every node and instance."""
    from hydracore_tpu_torch.utils import spans

    sc = _instanced_scene(same=200).to(cuda)
    assert sc.inst_woop.shape[0] == 201
    blocks, R = _random_blocks(sc.cl_tris.device, [-3, -1, -3], [3, 3, 3],
                               tc.R_BLK, 3.0)
    pool = tc.scene_pool(sc)
    twin_pool = {k: v for k, v in pool.items() if k not in tc.LEVEL_TABLES}
    with spans.recording():
        t_k, s_k = tc.cluster_traverse(blocks, any_hit_mode=any_hit_mode,
                                       **pool)
    got = spans.take().counters[tc.VOTES_COUNTER]
    t_t, s_t = tc.cluster_traverse_plain(blocks, any_hit_mode=any_hit_mode,
                                         **twin_pool)
    hit = s_k >= 0
    assert int(hit.sum()) > 100
    assert torch.equal(hit, s_t >= 0)
    assert torch.equal(t_k, t_t)
    least, _ = tc.walk_counts(blocks, pool, t_k.reshape(-1))
    most, _ = tc.walk_counts(blocks, pool)
    assert int(least.sum()) <= got <= int(most.sum())
    Nn = sc.lvl_node_bounds.shape[1]
    assert int(most.max()) <= 201 + Nn


def test_instanced_kernel_needs_the_instance_level(cuda):
    sc = _instanced_scene().to(cuda)
    pool = {k: v for k, v in tc.scene_pool(sc).items()
            if k not in tc.LEVEL_TABLES}
    with pytest.raises(ValueError, match="B3 needs the upper level"):
        tc.cluster_traverse(torch.zeros((1, 64, 8), device=cuda), **pool)


@pytest.mark.parametrize("any_hit_mode", [False, True])
@pytest.mark.parametrize("pool_kind", ["flat", "chunked"])
def test_b1_b2_equal_their_twin_bit_for_bit(cuda, any_hit_mode, pool_kind):
    """The B1/B2 path, flat and chunked, after B3 moved to a kernel of its
    own: t (occlusion in any-hit mode) and closest-hit slots equal to the
    twin's bit for bit. An any-hit slot names whichever occluder was found
    first, the twin's the nearest."""
    sc = _rects_scene(30000, part_cap=128 if pool_kind == "chunked" else 1024)
    sc = sc.to(cuda)
    blocks, _ = _random_blocks(cuda, -5, 5, 64, 1.0)
    pool = (sc.cl_bounds_oct, sc.cl_tris, sc.cl_oct_perm)
    t_k, s_k = tc.cluster_traverse(blocks, any_hit_mode=any_hit_mode,
                                   **tc.scene_pool(sc))
    t_t, s_t = tc.cluster_traverse_plain(blocks, *pool,
                                         any_hit_mode=any_hit_mode)
    torch.cuda.synchronize()
    assert int((s_k >= 0).sum()) > 100
    assert torch.equal(t_k, t_t) and torch.equal(s_k >= 0, s_t >= 0)
    if not any_hit_mode:
        assert torch.equal(s_k, s_t)


def test_wrapper_refuses_mixed_devices(cuda):
    sc = _rects_scene()
    blocks = torch.zeros((2, tc.R_BLK, 8), device=cuda)
    with pytest.raises(ValueError, match="cpu"):
        tc.cluster_traverse(blocks, sc.cl_bounds_oct, sc.cl_tris,
                            sc.cl_oct_perm)


def _grazing_blocks(sc, r_blk, n=6144):
    """Rays in the plane of a group box face (the origin outside or on the
    face, a third exactly on a corner, the direction in the plane) and rays
    from inside group boxes, t limits infinite or finite."""
    rng = np.random.default_rng(23)
    gb = sc.lvl_bounds.cpu().numpy()
    pick = rng.integers(0, gb.shape[1], n)
    bmin, bmax = gb[0:3, pick].T, gb[3:6, pick].T
    axis = rng.integers(0, 3, n)
    face = np.where(rng.integers(0, 2, n) == 1, bmax[np.arange(n), axis],
                    bmin[np.arange(n), axis])
    o = rng.uniform(bmin - 1.0, bmax + 1.0)
    o[np.arange(n), axis] = face
    corner = np.arange(n) % 3 == 0
    o[corner] = np.where(rng.integers(0, 2, (corner.sum(), 3)) == 1,
                         bmax[corner], bmin[corner])
    inside = np.arange(n) % 3 == 1
    o[inside] = rng.uniform(bmin[inside], bmax[inside])
    d = rng.normal(size=(n, 3))
    d[~inside, axis[~inside]] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dev = sc.cl_tris.device
    t_max = torch.where(torch.arange(n, device=dev) % 2 == 0, 1e30, 2.0)
    return tc._to_blocks(torch.tensor(o, dtype=torch.float32, device=dev),
                         torch.tensor(d, dtype=torch.float32, device=dev),
                         t_max, None, r_blk)[0], n


@pytest.mark.parametrize("any_hit_mode", [False, True])
@pytest.mark.parametrize("rays", ["random", "grazing"])
@pytest.mark.parametrize("pool_kind", ["flat", "chunked", "one group"])
def test_group_walk_matches_twin(cuda, pool_kind, rays, any_hit_mode):
    """B1/B2 as a two-level walk (groups of clusters of every chunk in one
    front-to-back order, then the entered groups' clusters) against the
    twin, which tests every cluster: equal hit masks and t, slots equal on
    >= 99.9% (the cull changes no box test, so only the pick among equal t
    may differ), occlusion equal; on a pool of one group too, and on rays
    that graze group faces or start inside group boxes."""
    n_rects = {"flat": 30000, "chunked": 30000, "one group": 350}[pool_kind]
    sc = _rects_scene(n_rects, part_cap=128 if pool_kind == "chunked"
                      else 1024).to(cuda)
    Gn = sc.lvl_bounds.shape[1]
    assert (Gn == 1) == (pool_kind == "one group")
    assert (sc.cl_tris.dim() == 4) == (pool_kind == "chunked")
    if rays == "random":
        lo, hi = (-6, 6) if n_rects == 350 else (-5, 5)
        blocks, R = _random_blocks(cuda, lo, hi, tc.R_BLK_BOUNCE, 1.0)
    else:
        blocks, R = _grazing_blocks(sc, tc.R_BLK_BOUNCE)
    pool = tc.scene_pool(sc)
    twin = (sc.cl_bounds_oct, sc.cl_tris, sc.cl_oct_perm)
    before = (tc.closest_launches, tc.any_launches)
    t_k, s_k = tc.cluster_traverse(blocks, any_hit_mode=any_hit_mode, **pool)
    after = (tc.closest_launches, tc.any_launches)
    t_t, s_t = tc.cluster_traverse_plain(blocks, *twin,
                                         any_hit_mode=any_hit_mode)
    torch.cuda.synchronize()
    assert after[int(any_hit_mode)] == before[int(any_hit_mode)] + 1
    hit = s_k >= 0
    assert 50 < int(hit.sum()) < R
    assert torch.equal(hit, s_t >= 0)
    assert torch.equal(t_k, t_t)
    if not any_hit_mode:
        assert float((s_k[hit] == s_t[hit]).float().mean()) >= 0.999
    # the kernel reads the level, not the twin's cbl_oct and perm
    t_n, s_n = tc.cluster_traverse(
        blocks, any_hit_mode=any_hit_mode,
        **{k: v for k, v in pool.items() if k not in ("cbl_oct", "perm")})
    assert torch.equal(t_n, t_k) and torch.equal(s_n, s_k)


def test_b1_b2_need_the_group_level(cuda):
    sc = _rects_scene(30000, part_cap=128).to(cuda)
    pool = {k: v for k, v in tc.scene_pool(sc).items()
            if k not in tc.LEVEL_TABLES}
    for any_hit_mode in (False, True):
        with pytest.raises(ValueError, match="B1/B2 needs the upper level"):
            tc.cluster_traverse(torch.zeros((1, 64, 8), device=cuda),
                                any_hit_mode=any_hit_mode, **pool)


@pytest.mark.parametrize("any_hit_mode", [False, True])
@pytest.mark.parametrize("n_rects", [350, 30000])
def test_packet_kernel_matches_twin(cuda, any_hit_mode, n_rects):
    """B4: one warp per packet of 32 rays, the twin steps every packet with
    its own stack row in the same order."""
    sc = _rects_scene(n_rects, traversal="packet").to(cuda)
    rng = np.random.default_rng(3)
    R = 5000  # a ragged last packet
    lo, hi = (-6, 6) if n_rects == 350 else (-5, 5)
    ro = torch.tensor(rng.uniform(lo, hi, (R, 3)), dtype=torch.float32, device=cuda)
    rd = torch.tensor(rng.normal(size=(R, 3)), dtype=torch.float32, device=cuda)
    rd = rd / rd.norm(dim=1, keepdim=True)
    act = torch.tensor(np.arange(R) % 7 != 0, device=cuda)
    t_short = 4.0 if n_rects == 350 else 1.0
    t_max = torch.where(torch.arange(R, device=cuda) % 3 == 0, t_short, 1e30)
    packets, _ = tp._to_packets(ro, rd, t_max, act)
    before = (tp.closest_launches, tp.any_launches)
    out_k = tp.packet_traverse(packets, sc.pkt_nodes, sc.pkt_tris,
                               any_hit_mode=any_hit_mode)
    after = (tp.closest_launches, tp.any_launches)
    out_t = tp.packet_traverse_plain(packets, sc.pkt_nodes, sc.pkt_tris,
                                     any_hit_mode=any_hit_mode)
    torch.cuda.synchronize()
    assert after[int(any_hit_mode)] == before[int(any_hit_mode)] + 1
    assert after[1 - int(any_hit_mode)] == before[1 - int(any_hit_mode)]
    (t_k, u_k, v_k, s_k, n_k), (t_t, u_t, v_t, s_t, n_t) = out_k, out_t
    assert 100 < int((s_k >= 0).sum()) < R
    assert not (s_k.reshape(-1)[:R][~act] >= 0).any()
    assert 0 < int(n_k.max()) < tp.MAX_VISITS
    assert torch.equal(n_k, n_t)
    assert torch.equal(s_k, s_t)
    assert torch.equal(t_k, t_t)
    assert torch.equal(u_k, u_t) and torch.equal(v_k, v_t)
    # and the ray-by-ray walk of the same tree finds the same nearest hits
    if not any_hit_mode:
        from hydracore_tpu_torch.ops import traverse_wide as tw
        t_p, tri_p, _, _ = tp.closest_hit(sc, ro, rd, t_max, act)
        t_w, tri_w, _, _ = tw.closest_hit(sc, ro, rd, t_max, act)
        assert torch.equal(torch.isfinite(t_p), torch.isfinite(t_w))
        assert float((tri_p == tri_w).float().mean()) > 0.999


def _packet_rays(cuda, R: int, seed: int):
    """R random rays over the 350 rects in packets: every third with a short
    t limit, every seventh inactive (the last packet ragged unless R is a
    multiple of 32)."""
    rng = np.random.default_rng(seed)
    ro = torch.tensor(rng.uniform(-6, 6, (R, 3)), dtype=torch.float32, device=cuda)
    rd = torch.tensor(rng.normal(size=(R, 3)), dtype=torch.float32, device=cuda)
    rd = rd / rd.norm(dim=1, keepdim=True)
    t_max = torch.where(torch.arange(R, device=cuda) % 3 == 0, 4.0, 1e30)
    act = torch.tensor(np.arange(R) % 7 != 0, device=cuda)
    return tp._to_packets(ro, rd, t_max, act)[0]


def _assert_equal_outputs(a, b):
    for name, x, y in zip(("t", "u", "v", "slot", "visits"), a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("any_hit_mode", [False, True])
@pytest.mark.parametrize("case", ["37 rays", "more packets than warps",
                                  "two launches", "graph replayed 3 times"])
def test_packet_queue_matches_twin(cuda, case, any_hit_mode):
    """B4's persistent warps take packets from a queue that the last warp
    out resets: fewer packets than one CTA's warps, more packets than the
    card holds warps (with inactive rays), two launches in a row, and one
    launch captured in a CUDA graph and replayed three times (its outputs
    overwritten before each replay), each equal to the twin bit for bit."""
    sc = _rects_scene(traversal="packet").to(cuda)
    walk = (sc.pkt_nodes, sc.pkt_tris, any_hit_mode)
    if case == "37 rays":
        sets = [_packet_rays(cuda, 37, 1)]
    elif case == "more packets than warps":
        sets = [_packet_rays(cuda, (1 << 18) + 5, 2)]
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert sets[0].shape[0] > sms * tp.ctas_per_sm(any_hit_mode) * 8
    else:
        sets = [_packet_rays(cuda, 5000, 3), _packet_rays(cuda, 3000, 4)]
    if case == "graph replayed 3 times":
        packets = sets[0]
        tp.packet_traverse(packets, *walk)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = tp.packet_traverse(packets, *walk)
        ref = tp.packet_traverse_plain(packets, *walk)
        for _ in range(3):
            for x in out:
                x.fill_(-7)
            g.replay()
            torch.cuda.synchronize()
            _assert_equal_outputs(out, ref)
        return
    outs = [tp.packet_traverse(packets, *walk) for packets in sets]
    torch.cuda.synchronize()
    for packets, out in zip(sets, outs):
        assert 0 < int(out[4].max()) < tp.MAX_VISITS
        _assert_equal_outputs(out, tp.packet_traverse_plain(packets, *walk))


@pytest.mark.parametrize("any_hit_mode", [False, True])
def test_packet_profile_matches_plain(cuda, any_hit_mode):
    """The profiling instantiation gives the plain one's outputs and visit
    counts, node + leaf entries equal to the visits, a clock that runs
    forward and the SM each packet ran on."""
    sc = _rects_scene(traversal="packet").to(cuda)
    packets = _packet_rays(cuda, 20000, 5)
    prof = torch.zeros((packets.shape[0], 5), dtype=torch.int64, device=cuda)
    plain = tp.packet_traverse(packets, sc.pkt_nodes, sc.pkt_tris, any_hit_mode)
    out = tp.packet_traverse(packets, sc.pkt_nodes, sc.pkt_tris, any_hit_mode,
                             profile=prof)
    torch.cuda.synchronize()
    _assert_equal_outputs(out, plain)
    start, end, sm, n_node, n_leaf = prof.unbind(dim=1)
    assert torch.equal(n_node + n_leaf, plain[4].long())
    assert bool((n_node >= 1).all()) and bool((end > start).all())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 0 <= int(sm.min()) and int(sm.max()) < sms
    with pytest.raises(ValueError, match="profile"):
        tp.packet_traverse(packets, sc.pkt_nodes, sc.pkt_tris, any_hit_mode,
                           profile=prof[:-1])
    with pytest.raises(ValueError, match="profile"):
        tp.packet_traverse(packets, sc.pkt_nodes, sc.pkt_tris, any_hit_mode,
                           profile=prof.int())


def test_packet_wrapper_refuses_mixed_devices(cuda):
    sc = _rects_scene()
    packets = torch.zeros((2, tp.PKT, 8), device=cuda)
    with pytest.raises(ValueError, match="cpu"):
        tp.packet_traverse(packets, sc.pkt_nodes, sc.pkt_tris)


def test_packet_render_on_card_matches_cpu_twins(cuda, monkeypatch):
    """The packet route on the card goes through B4 and nothing else, and
    gives the CPU twins' image and the cluster route's."""
    sc = _box_scene(32, traversal="packet")
    tc.reset_launch_counts()
    tp.reset_launch_counts()
    peaks = []
    monkeypatch.setattr(tp, "visits_hook", lambda n: peaks.append(n.max()))
    img_card = pt.render(sc, spp=4, seed=777, device=cuda).cpu()
    monkeypatch.setattr(tp, "visits_hook", None)
    assert tp.closest_launches > 0 and tp.any_launches > 0
    assert tc.closest_launches == 0 and tc.any_launches == 0
    assert len(peaks) == tp.closest_launches + tp.any_launches
    assert 0 < max(int(p) for p in peaks) < tp.MAX_VISITS
    img_cpu = pt.render(sc, spp=4, seed=777, device="cpu")
    img_cl = pt.render(_box_scene(32), spp=4, seed=777, device=cuda).cpu()
    assert torch.isfinite(img_card).all() and float(img_card.mean()) > 0.01
    for other in (img_cpu, img_cl):
        agree = float(((img_card - other).abs().amax(dim=-1) <= 1e-3)
                      .float().mean())
        assert agree >= 0.99, agree


def test_render_on_card_matches_cpu_twins(cuda):
    sc = _box_scene(32)
    before = (tc.closest_launches, tc.any_launches)
    img_card = pt.render(sc, spp=4, seed=777, device=cuda)
    assert tc.closest_launches > before[0] and tc.any_launches > before[1]
    img_cpu = pt.render(sc, spp=4, seed=777, device="cpu")
    img_card = img_card.cpu()
    assert torch.isfinite(img_card).all() and float(img_card.mean()) > 0.01
    agree = float(((img_card - img_cpu).abs().amax(dim=-1) <= 1e-3)
                  .float().mean())
    assert agree >= 0.99, agree


def test_instanced_render_on_card(cuda):
    """The instanced scene through B3 on the card against the CPU twins
    and against the flattened layout through B1/B2."""
    inst, flat = _instanced_scene(), _instanced_scene(instancing="off")
    tc.reset_launch_counts()
    img_card = pt.render(inst, spp=4, seed=3, device=cuda).cpu()
    assert tc.inst_closest_launches > 0 and tc.inst_any_launches > 0
    assert tc.closest_launches == 0 and tc.any_launches == 0
    img_cpu = pt.render(inst, spp=4, seed=3, device="cpu")
    img_flat = pt.render(flat, spp=4, seed=3, device=cuda).cpu()
    assert tc.closest_launches > 0 and tc.any_launches > 0
    assert torch.isfinite(img_card).all() and float(img_card.mean()) > 0.01
    agree = float(((img_card - img_cpu).abs().amax(dim=-1) <= 1e-3)
                  .float().mean())
    assert agree >= 0.99, agree
    assert float(((img_card - img_flat) ** 2).mean()) < 1e-4


@pytest.mark.parametrize("onehot", [False, True])
def test_lab_gather_kernel_matches_plain(cuda, onehot):
    """The tool's inputs at 2,000 rows: S 512 takes the window path, S
    16,384 the direct kernel (t7.uses_window); the direct kernel on both.
    Each equal to the plain version, and counted on its path."""
    name = "onehot" if onehot else "taa"
    for s, path in ((512, "window"), (16384, "direct")):
        pool, idx = t7.inputs(2000, s, device=cuda)  # 2000 rows: 250 CTAs
        before = dict(t7.launches)
        out_k = t7.gather(pool, idx, onehot=onehot)
        out_d = t7.gather_direct(pool, idx, onehot=onehot)
        after = dict(t7.launches)
        out_p = t7.gather_plain(pool, idx, onehot=onehot)
        torch.cuda.synchronize()
        grown = {k: after[k] - before[k] for k in after}
        want = {k: 0 for k in after}
        want[(name, path)] += 1
        want[(name, "direct")] += 1
        assert grown == want, s
        assert torch.equal(out_k, out_p) and torch.equal(out_d, out_p), s


@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("name", t7.ADVERSARIAL)
def test_lab_gather_adversarial_matches_plain(cuda, name, onehot):
    """T7 on t7.adversarial_inputs (idx at the int32 ends and rows whose
    idx + it wraps at S 3000 and S 5, non-finite pools, bf16 ties,
    subnormals, overflowing sums, 0 and 1 iterations, S > R): gather() on
    the path its shapes choose and the direct kernel, bit for bit against
    the plain version, any NaN matching any NaN."""
    pool, idx, iters = t7.adversarial_inputs(cuda)[name]
    path = ("window" if t7.uses_window(idx.shape[0], pool.shape[0], iters)
            else "direct")
    key = ("onehot" if onehot else "taa", path)
    before = t7.launches[key]
    out_k = t7.gather(pool, idx, iters, onehot)
    assert t7.launches[key] == before + 1
    out_d = t7.gather_direct(pool, idx, iters, onehot)
    out_p = t7.gather_plain(pool, idx, iters, onehot)
    torch.cuda.synchronize()
    assert t7.same_bits(out_k, out_p)
    assert t7.same_bits(out_d, out_p)
    if name in ("wrap_3000", "small_pool"):  # the window path's direct rows
        assert path == "window"
        assert t7.wrapping_rows(idx, pool.shape[0], iters) > 0


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits (torch.equal is false on NaN)."""
    return t.contiguous().view(torch.int32)


def test_lab_prim_kernels_match_plain(cuda):
    """The ten probes on the tool's x, a normal draw and k8's adversarial
    inputs (a NaN, a row of -inf, ties of -0.0 and +0.0): bit for bit."""
    x, xi = t6.inputs(cuda)
    rng = np.random.default_rng(2)
    xr = torch.tensor(rng.normal(size=t6.SHAPE).astype(np.float32), device=cuda)
    cases = [(x, xi), (xr, xi)] + list(t6.adversarial_inputs(cuda).values())
    before = t6.prim_launches
    for k in range(1, 11):
        for xx, xxi in cases:
            got, want = t6.prim(k, xx, xxi), t6.prim_plain(k, xx, xxi)
            assert torch.equal(_bits(got), _bits(want)), k
    assert t6.prim_launches == before + 10 * len(cases)


def test_lab_launch_floor_runs(cuda):
    """The empty kernel that T6's times stand beside launches, synchronizes
    and counts as no probe."""
    before = t6.prim_launches
    for _ in range(3):
        t6.empty(cuda)
    torch.cuda.synchronize()
    assert t6.prim_launches == before


@pytest.mark.parametrize("name", list(t5.VARIANTS))
def test_lab_subvisit_kernel_matches_plain(cuda, name):
    n_bands, interleave = t5.VARIANTS[name]
    rays, tris, lst = t5.inputs(4, 16, 8, seed=1, device=cuda)
    before = t5.plain_launches + t5.sub_launches
    out_k = t5.subvisit(rays, tris, lst, n_bands, interleave)
    assert t5.plain_launches + t5.sub_launches == before + 1
    out_p = t5.subvisit_plain(rays, tris, lst, n_bands, interleave)
    torch.cuda.synchronize()
    assert 0 < int((out_k < 1e38).sum()) < out_k.numel()
    assert torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))


@pytest.mark.parametrize("name", t5.ADVERSARIAL)
def test_lab_subvisit_adversarial_matches_plain(cuda, name):
    """T5 on t5.adversarial_inputs (dw = +-0 with ow = 0 and ow != 0, -0.0
    in rays and rows, subnormal dw and ow, t at 1e-5 and at the tagged
    t_cur, ties across lanes, steps with no candidate, misses on every
    lane), every variant, the timed build and the profiling build: every
    word bit for bit."""
    rays, tris, lst = t5.adversarial_inputs(cuda)[name]
    for variant, (n_bands, interleave) in t5.VARIANTS.items():
        want = t5.subvisit_plain(rays, tris, lst, n_bands, interleave)
        got = t5.subvisit(rays, tris, lst, n_bands, interleave)
        prof = torch.zeros(len(t5.PROFILE), dtype=torch.int64, device=cuda)
        got_p = t5.subvisit(rays, tris, lst, n_bands, interleave, profile=prof)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), variant
        assert torch.equal(_bits(got_p), _bits(want)), variant
        walk, kept = prof.tolist()
        assert 0 < walk <= kept <= 32 * walk, variant


def test_lab_subvisit_profile_counts(cuda):
    """The profiling build on the tool's draws: its output the plain
    version's, and its counts those of a kept set that holds every
    candidate (t in (1e-5, t_cur)) of the steps."""
    rays, tris, lst = t5.inputs(4, 16, 8, seed=1, device=cuda)
    prof = torch.zeros(len(t5.PROFILE), dtype=torch.int64, device=cuda)
    got = t5.subvisit(rays, tris, lst, 1, False, profile=prof)
    want = t5.subvisit_plain(rays, tris, lst, 1, False)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    walk, kept = prof.tolist()
    assert 0 < walk <= kept <= rays.shape[0] * 16 * t5.LANES
    with pytest.raises(ValueError, match="profile"):
        t5.subvisit(rays, tris, lst, profile=prof[:1])


@pytest.mark.parametrize("variant", ["floor", "fm4", "stagea1", "stagea3",
                                     "compact1", "compact2"])
def test_lab_cluster_cost_kernel_matches_plain(cuda, variant):
    sc = t1.bench_scene(64, 64).to(cuda)
    rays, oct_ = t1.lab_rays(sc, 64)
    rays[0, :, 7] = 0.0  # a block without a live ray: its scan ends at once
    rays[1, ::2, 7] = 0.0  # dead rays of a live block still set bits
    kind, n = t1.parse(variant)
    counts = lambda: (t1.floor_launches, t1.stagea_launches,  # noqa: E731
                      t1.compact_launches)
    before = counts()
    out_k, outi_k = t1.cluster_cost(kind, rays, oct_, sc.cl_bounds_oct, n)
    after = counts()
    out_p, outi_p = t1.cluster_cost_plain(kind, rays, oct_, sc.cl_bounds_oct, n)
    torch.cuda.synchronize()
    assert sum(after) == sum(before) + 1
    assert torch.equal(outi_k, outi_p) and torch.equal(out_k, out_p)
    if kind in ("stagea", "compact"):
        assert float(out_k.max()) > 0


@pytest.mark.parametrize("use_mxu", [False, True])
@pytest.mark.parametrize("mode", sorted(t2.MODES.values()))
@pytest.mark.parametrize("r_blk", t2.R_BLKS)
def test_lab_proto_cluster_kernel_matches_plain(cuda, r_blk, mode, use_mxu):
    """T2 on 4,096 of the tool's rays; the MXU variant with random plane
    columns in pk, so that its hits are held too."""
    cb, tris, pk = t2.synth(256, 16)
    if use_mxu:
        pk = t2.with_planes(pk)
    rays = t2.probe_rays(r_blk, 4096)
    args = [torch.tensor(x).to(cuda) for x in (rays, cb, tris, pk)]
    before = t2.launches
    out_k, outi_k = t2.proto_cluster(*args, use_mxu=use_mxu, mode=mode)
    assert t2.launches == before + 1
    out_p, outi_p = t2.proto_cluster_plain(*args, use_mxu=use_mxu, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p) and torch.equal(outi_k, outi_p)
    hits = int((outi_k[:, :, 0] >= 0).sum())
    assert (hits > 0) if mode == 0 else (hits == 0)


@pytest.mark.parametrize("name", t2.ADVERSARIAL)
def test_lab_proto_cluster_adversarial_matches_plain(cuda, name):
    """T2 on t2.adversarial_inputs (ties within and across clusters, an
    empty list beside a full one, lists of 0 to 15 entries, Cp 384, R_BLK
    1024 with plane columns), every mode: out and outi bit for bit."""
    rays, cb, tris, pk, use_mxu = t2.adversarial_inputs()[name]
    args = [torch.tensor(x).to(cuda) for x in (rays, cb, tris, pk)]
    for mode in sorted(t2.MODES.values()):
        out_k, outi_k = t2.proto_cluster(*args, use_mxu=use_mxu, mode=mode)
        out_p, outi_p = t2.proto_cluster_plain(*args, use_mxu=use_mxu,
                                               mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out_k), _bits(out_p)), mode
        assert torch.equal(outi_k, outi_p), mode
        if mode == 0:
            assert int((outi_k[:, :, 0] >= 0).sum()) > 10


@pytest.mark.parametrize("tool", [t3, t4])
def test_lab_packet_walk_kernel_matches_plain(cuda, tool):
    """T3 and T4 on the 350 rects, 2 packets of random rays: t, u, v, slot
    and visits equal."""
    sc = _rects_scene().to(cuda)
    nodes, tris = tool.pack_scene(sc)
    rng = np.random.default_rng(3)
    R = 2 * tool.P
    ro = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rays = tool.pack_rays(ro, rd).to(cuda)
    before = tool.launches
    out_k = tool.unpack(tool.packet_traverse(rays, nodes, tris))
    assert tool.launches == before + 1
    out_p = tool.unpack(tool.packet_traverse_plain(rays, nodes, tris))
    torch.cuda.synchronize()
    assert 20 < int((out_k[1] >= 0).sum()) < R
    assert 0 < int(out_k[4].min()) and int(out_k[4].max()) < tool.MAX_VISITS
    for k, p in zip(out_k, out_p):
        assert torch.equal(k, p)


@pytest.mark.parametrize("name", t1.ADVERSARIAL)
def test_lab_cluster_cost_adversarial_matches_plain(cuda, name):
    """T1 on t1.adversarial_inputs (a block without a live ray and one with
    one, |d| < 1e-12 of both signs and -0.0, NaN origins, origins and boxes
    at +-1e30, inverted boxes, Cp 400), every variant: out and outi bit for
    bit."""
    rays, oct_, cbl = t1.adversarial_inputs(cuda)[name]
    for variant in ("floor", "fm2", "stagea1", "stagea2", "compact1",
                    "compact2"):
        kind, n = t1.parse(variant)
        out_k, outi_k = t1.cluster_cost(kind, rays, oct_, cbl, n)
        out_p, outi_p = t1.cluster_cost_plain(kind, rays, oct_, cbl, n)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out_k), _bits(out_p)), variant
        assert torch.equal(outi_k, outi_p), variant
        if kind in ("stagea", "compact"):
            assert float(out_k[:, 0, 0].max()) > 0


def _t4_equal(k, p) -> bool:
    return all(torch.equal(_bits(a) if a.is_floating_point() else a,
                           _bits(b) if b.is_floating_point() else b)
               for a, b in zip(k, p))


@pytest.mark.parametrize("name", t3.ADVERSARIAL)
def test_lab_t3_adversarial_matches_plain(cuda, name):
    """T3 on t3.adversarial_inputs ("edges": T4's case in packets of 128;
    "max_visits": a packet cut at 4,096 pops; "sumuv": the tool's u and v
    sums where a loser's term is NaN and where the zeros' signs decide): t,
    slot bits, u, v, visits and the zero rows bit for bit."""
    rays8, nodes, tris = t3.adversarial_inputs(cuda)[name]
    before = t3.launches
    out_k = t3.packet_traverse(rays8, nodes, tris)
    assert t3.launches == before + 1
    out_p = t3.packet_traverse_plain(rays8, nodes, tris)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out_k), _bits(out_p))
    vis = out_k[4].reshape(-1, t3.P)[:, 0]
    if name == "max_visits":
        assert vis.tolist() == [float(t3.MAX_VISITS)]
    elif name == "sumuv":
        assert torch.isnan(out_k[2]).any() and torch.isnan(out_k[3]).any()
        assert (_bits(out_k[2]) == -2 ** 31).any()  # a -0.0 winner kept
    else:
        assert vis[8:].tolist() == [1.0] * 8


def test_lab_t3_profile_matches_plain(cuda):
    """T3's profiling build on 2 packets of random rays over the 350 rects:
    the plain version's outputs, bit for bit, and a profile whose node and
    leaf entries sum to the visits."""
    sc = _rects_scene().to(cuda)
    nodes, tris = t3.pack_scene(sc)
    rng = np.random.default_rng(5)
    ro = rng.uniform(-6, 6, (2 * t3.P, 3)).astype(np.float32)
    rd = rng.normal(size=(2 * t3.P, 3)).astype(np.float32)
    rays = t3.pack_rays(ro, rd).to(cuda)
    out_p = t3.packet_traverse_plain(rays, nodes, tris)
    prof = torch.zeros((2, len(t3.PROFILE)), dtype=torch.int64, device=cuda)
    out_k = t3.packet_traverse(rays, nodes, tris, profile=prof)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out_k), _bits(out_p))
    prof = prof.cpu()
    vis = out_p[4].reshape(2, t3.P)[:, 0].cpu()
    assert torch.equal((prof[:, 3] + prof[:, 4]).float(), vis)
    assert (prof[:, 1] > prof[:, 0]).all() and (prof[:, 3] > 0).all()
    assert (prof[:, 5] <= prof[:, 3] * t3.WARPS * 8).all()  # live children
    assert (prof[:, 6] <= prof[:, 7]).all()  # past the first pass: tested
    assert (prof[:, 7] <= prof[:, 4] * t3.WARPS * 8).all()
    with pytest.raises(ValueError, match="profile"):
        t3.packet_traverse(rays, nodes, tris, profile=prof[:1].to(cuda))


@pytest.mark.parametrize("name", t4.ADVERSARIAL)
def test_lab_t4_adversarial_matches_plain(cuda, name):
    """T4 on t4.adversarial_inputs ("edges": signed zeros and +-1e-13 in d,
    rays on and in box faces, ties in a leaf and across leaves, a packet
    that enters nothing; "max_visits": a packet cut at 16,384 pops;
    "clamp": a stack driven past STACK_D - 1): t, u, v, slot and visits bit
    for bit."""
    rays7, nodes, tris = t4.adversarial_inputs(cuda)[name]
    before = t4.launches
    out_k = t4.unpack(t4.packet_traverse(rays7, nodes, tris))
    assert t4.launches == before + 1
    out_p = t4.unpack(t4.packet_traverse_plain(rays7, nodes, tris))
    torch.cuda.synchronize()
    assert _t4_equal(out_k, out_p)
    if name == "max_visits":
        assert out_k[4].tolist() == [float(t4.MAX_VISITS)]
    elif name == "clamp":
        assert 0 < out_k[4].item() < t4.MAX_VISITS
    else:
        assert out_k[4].tolist() == [8.0, 1.0]


def test_lab_t4_profile_matches_plain(cuda):
    """T4's profiling build on 2 packets of random rays over the 350 rects:
    the plain version's outputs, bit for bit, and a profile whose node and
    leaf entries sum to the visits."""
    sc = _rects_scene().to(cuda)
    nodes, tris = t4.pack_scene(sc)
    rng = np.random.default_rng(5)
    ro = rng.uniform(-6, 6, (2 * t4.P, 3)).astype(np.float32)
    rd = rng.normal(size=(2 * t4.P, 3)).astype(np.float32)
    rays = t4.pack_rays(ro, rd).to(cuda)
    out_p = t4.unpack(t4.packet_traverse_plain(rays, nodes, tris))
    prof = torch.zeros((2, len(t4.PROFILE)), dtype=torch.int64, device=cuda)
    out_k = t4.unpack(t4.packet_traverse(rays, nodes, tris, profile=prof))
    torch.cuda.synchronize()
    assert _t4_equal(out_k, out_p)
    prof = prof.cpu()
    assert torch.equal((prof[:, 3] + prof[:, 4]).float(), out_p[4].cpu())
    assert (prof[:, 1] > prof[:, 0]).all() and (prof[:, 3] > 0).all()
    assert (prof[:, 5] >= prof[:, 3] * t4.WARPS).all()  # a test a child at least
    assert (prof[:, 6] <= prof[:, 4] * t4.WARPS * 8).all()
    with pytest.raises(ValueError, match="profile"):
        t4.packet_traverse(rays, nodes, tris, profile=prof[:1].to(cuda))


def _alpha_scene(size: int = 32, part_cap: int = 1024,
                 traversal: str = "cluster"):
    """40 opacity-mapped quads (a checker of opacities 0, 0.35, 0.7, 1)
    over a floor beside an opaque sphere, under a point and a rect light:
    8,148 triangles in a flat pool, or with part_cap=128 a finer sphere,
    79,684 triangles in 8 chunks of 128 clusters."""
    st = TextureStorage()
    ys, xs = np.mgrid[0:8, 0:8]
    op = np.ones((8, 8, 4), np.float32)
    op[..., 0] = np.array([0.0, 0.35, 0.7, 1.0])[(xs // 2 + ys // 2) % 4]
    slot = st.add(op)
    b = SceneBuilder()
    floor = b.lambert([0.8, 0.8, 0.8])
    b.add_rect([0, 0, 0], [3, 0, 0], [0, 0, 3], floor, flip=True)
    soft = b.add_material(diff_color=np.array([0.7, 0.3, 0.2], np.float32),
                          opacity_tex=slot)
    rng = np.random.default_rng(4)
    for _ in range(40):
        b.add_rect(rng.uniform([-2, 0.3, -2], [2, 2, 2]),
                   rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.4, 0.4, 3), soft)
    n = 200 if part_cap == 128 else 64
    b.add_sphere([1.2, 0.7, -1.0], 0.5, floor, n_seg=n, n_ring=n)
    b.point_light([0.2, 2.5, 0.1], [14.0] * 3)
    b.rect_light([-0.8, 2.6, 0.8], 0.4, 0.4, [8.0] * 3)
    sc = b.build(cam_pos=[0, 3.5, 3.5], cam_lookat=[0, 0, 0], width=size,
                 height=size, trace_depth=4, part_cap=part_cap,
                 traversal=traversal)
    texels, table, samplers = st.finalize()
    return finalize_scene(dataclasses.replace(
        sc, texels=texels, tex_table=table, tex_sampler=samplers))


@pytest.mark.parametrize("pool_kind", ["flat", "chunked"])
def test_opaque_pool_b2_matches_twin(cuda, pool_kind):
    """B2 over the opaque shadow pool (cl_tris_shadow, the alpha lanes
    zeroed): occlusion equal to the twin's, counted in opaque_any_launches;
    rays stopped just past an alpha triangle hit the full pool and never
    the opaque one (t = -0/0 = NaN fails every test)."""
    sc = _alpha_scene(part_cap=128 if pool_kind == "chunked" else 1024)
    assert (sc.cl_tris_shadow.dim() == 4) == (pool_kind == "chunked")
    sc = sc.to(cuda)
    opaque = tc.scene_pool(sc, opaque_only=True)
    assert opaque["opaque_pool"]
    twin = {k: v for k, v in opaque.items()
            if k not in tc.LEVEL_TABLES and k != "opaque_pool"}
    blocks, R = _random_blocks(cuda, -2.5, 2.5, tc.R_BLK, 2.0)
    before = (tc.any_launches, tc.opaque_any_launches)
    _, s_k = tc.cluster_traverse(blocks, any_hit_mode=True, **opaque)
    assert (tc.any_launches, tc.opaque_any_launches) == (before[0],
                                                         before[1] + 1)
    _, s_t = tc.cluster_traverse_plain(blocks, any_hit_mode=True, **twin)
    _, s_f = tc.cluster_traverse(blocks, any_hit_mode=True, **tc.scene_pool(sc))
    torch.cuda.synchronize()
    assert torch.equal(s_k >= 0, s_t >= 0)
    assert ((s_f >= 0) & (s_k < 0)).any() and (s_k >= 0).any()
    tri = sc.alpha_tri9f[:, sc.alpha_tri_id >= 0]
    v0, e1, e2 = tri[0:3].T, tri[3:6].T, tri[6:9].T
    nrm = torch.linalg.cross(e1, e2)
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    c = v0 + (e1 + e2) / 3.0
    leaf, n_leaf = tc._to_blocks(c + 0.01 * nrm, -nrm, 0.011, None, tc.R_BLK)
    hits = [tc.cluster_traverse(leaf, any_hit_mode=True, **p)[1]
            .reshape(-1)[:n_leaf] >= 0 for p in (tc.scene_pool(sc), opaque)]
    zero_twin = tc.cluster_traverse_plain(leaf, any_hit_mode=True, **twin)[1]
    assert hits[0].all() and not hits[1].any()
    assert not (zero_twin.reshape(-1)[:n_leaf] >= 0).any()


@pytest.mark.parametrize("traversal", ["cluster", "packet"])
def test_alpha_render_on_card_matches_cpu_twins(cuda, traversal):
    """An alpha scene on the card against the CPU twins: on the cluster
    route its shadow rays take B2 over the opaque pool (the split walk), on
    the packet route the layered walk through B4 closest hit."""
    sc = _alpha_scene(traversal=traversal)
    tc.reset_launch_counts()
    tp.reset_launch_counts()
    img_card = pt.render(sc, spp=4, seed=777, device=cuda).cpu()
    if traversal == "cluster":
        assert tc.closest_launches > 0 and tc.opaque_any_launches > 0
        assert tc.any_launches == 0
    else:
        assert tp.closest_launches > 0 and tp.any_launches == 0
        assert tc.closest_launches == 0 and tc.opaque_any_launches == 0
    img_cpu = pt.render(sc, spp=4, seed=777, device="cpu")
    assert torch.isfinite(img_card).all() and float(img_card.mean()) > 0.01
    agree = float(((img_card - img_cpu).abs().amax(dim=-1) <= 1e-3)
                  .float().mean())
    assert agree >= 0.99, agree


@pytest.fixture
def dirt():
    """ao_dirt registered in the port's registry (id 0), cleared after."""
    from hydracore_tpu_torch.ops import proctex

    proctex.clear_registry()
    try:
        yield proctex.register_proc_tex(proctex.ao_dirt)
    finally:
        proctex.clear_registry()


def _gates_scene(pid, traversal: str = "cluster", size: int = 32):
    """A lit box holding an SSS sphere and a Beer-fog glass sphere over an
    AO-dirt floor (procedural texture `pid`, an 'up' hemisphere of 0.8)."""
    b = SceneBuilder()
    args = np.zeros(8, np.float32)
    args[0:3], args[3:6] = 0.05, 0.8
    floor = b.add_material(diff_color=np.ones(3, np.float32), diff_proc=pid,
                           proc_args=args, ao_type=1, ao_length=0.8)
    wall = b.lambert([0.6, 0.6, 0.6])
    b.add_box_interior(2.0, floor, wall, wall, b.lambert([0.7, 0.12, 0.1]),
                       b.lambert([0.12, 0.55, 0.18]))
    skin = b.add_material(diff_color=np.array([0.3, 0.2, 0.15], np.float32),
                          sss_density=1.2, sss_scattering=3.0,
                          sss_absorption=np.array([0.5, 0.15, 0.05],
                                                  np.float32),
                          sss_phase=0.3, sss_transmission=0.8)
    b.add_sphere([-0.7, -1.2, -0.3], 0.8, skin, n_seg=48, n_ring=24)
    glass = b.add_material(transp_color=np.ones(3, np.float32), transp_ior=1.5,
                           fog_color=np.array([0.9, 0.5, 0.3], np.float32),
                           fog_mult=1.5)
    b.add_sphere([0.9, -1.5, 0.6], 0.5, glass, n_seg=32, n_ring=16)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [12.0] * 3)
    sc = b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, -0.5, 0], width=size,
                 height=size, trace_depth=6, traversal=traversal)
    st = sc.settings
    assert st.has_sss and st.has_fog and st.has_proc_tex and st.has_proc_ao
    return sc


def test_ao_probe_b2_matches_twin(cuda, dirt):
    """B2 on the AO-probe wavefront (integrators/pt.py:ao_rays from the
    first hits, sorted as trace_api.ao_any_hit sorts it): occlusion equal
    to the twin's; ao_probe on the card equal to the CPU's on >= 99.9% of
    rays, its launches counted in ao_any_launches alone."""
    from hydracore_tpu_torch.ops import trace_api
    from hydracore_tpu_torch.scene import materials as MC

    host = _gates_scene(dirt)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        sc = host.to(dev)
        ray_o, ray_d, sidx, _ = pt.primary_rays(sc, [0], 777)
        t, tri, u, v = pt.closest_hit(sc, ray_o, ray_d)
        pos, n, ng, _, mat, _, _ = pt.compute_hit(sc, tri, u, v, ray_o, ray_d, t)
        row = sc.mat_attr[mat.long()]
        need = (tri >= 0) & (row[:, MC.MA_AO_TYPE] > 0)
        args = (pos, n, ng, row[:, MC.MA_AO_TYPE].to(torch.int32),
                row[:, MC.MA_AO_LENGTH], need,
                pt.rng.rand4(sidx, 0, pt.DG_AO, 777))
        tc.reset_launch_counts()
        out[dev.type] = pt.ao_probe(sc, *args).cpu()
        if dev.type == "cuda":
            assert tc.ao_any_launches == 1 and tc.any_launches == 0
            o, d, t_max, act = pt.ao_rays(*args)
            perm = trace_api.coherence_order(sc, o, d, act)
            blocks, _ = tc._to_blocks(o[perm], d[perm], t_max[perm],
                                      act[perm], tc.R_BLK)
            pool = tc.scene_pool(sc)
            twin = {k: w for k, w in pool.items() if k not in tc.LEVEL_TABLES}
            s_k = tc.cluster_traverse(blocks, any_hit_mode=True, **pool)[1]
            s_t = tc.cluster_traverse_plain(blocks, any_hit_mode=True,
                                            **twin)[1]
            assert torch.equal(s_k >= 0, s_t >= 0)
            assert (s_k >= 0).any() and int(act.sum()) > 100
    # the probe directions go through sin and cos, whose last ulp may
    # differ between the card and the CPU: a grazing probe may flip
    assert float((out["cuda"] == out["cpu"]).float().mean()) >= 0.999
    assert (out["cpu"] < 1.0).any()


@pytest.mark.parametrize("traversal", ["cluster", "packet"])
def test_gates_render_on_card_matches_cpu_twins(cuda, dirt, traversal):
    """SSS, fog and the AO-dirt floor on the card against the CPU twins at
    depth 6; on the cluster route the AO probes run through B2
    (ao_any_launches), on the packet route through B4."""
    sc = _gates_scene(dirt, traversal)
    tc.reset_launch_counts()
    tp.reset_launch_counts()
    img_card = pt.render(sc, spp=4, seed=777, device=cuda).cpu()
    if traversal == "cluster":
        assert tc.closest_launches > 0 and tc.any_launches > 0
        assert tc.ao_any_launches > 0
    else:
        assert tp.closest_launches > 0 and tp.any_launches > 0
        assert tc.ao_any_launches == 0
    img_cpu = pt.render(sc, spp=4, seed=777, device="cpu")
    assert torch.isfinite(img_card).all() and float(img_card.mean()) > 0.01
    agree = float(((img_card - img_cpu).abs().amax(dim=-1) <= 1e-3)
                  .float().mean())
    assert agree >= 0.99, agree


def test_layers_sum_on_card(cuda, dirt):
    """direct + indirect == color within 1e-4 on the card."""
    sc = _gates_scene(dirt)
    imgs = {}
    for layer in ("color", "direct", "indirect"):
        s = dataclasses.replace(sc, settings=dataclasses.replace(
            sc.settings, render_layer=layer))
        imgs[layer] = pt.render(s, spp=2, seed=777, device=cuda).cpu()
    assert torch.allclose(imgs["direct"] + imgs["indirect"], imgs["color"],
                          atol=1e-4)
    assert float(imgs["direct"].sum()) > 0.05 * float(imgs["color"].sum())
    assert float(imgs["indirect"].sum()) > 0.05 * float(imgs["color"].sum())


def _close_share(a, b) -> float:
    a, b = a.cpu(), b.cpu()
    if a.dim() == 2:
        a, b = a[..., None], b[..., None]
    same_inf = torch.isinf(a) & torch.isinf(b)
    d = torch.where(same_inf, 0.0, a - b).abs().amax(dim=-1)
    return float((d <= 1e-3).float().mean())


@pytest.mark.parametrize("traversal", ["cluster", "packet"])
def test_lt_on_card_matches_cpu_twins(cuda, traversal):
    """render_lt on the card (light rays unsorted through B1 or B4, the
    camera connections through B2 or B4's any-hit mode) against the CPU
    twins: >= 99% of pixels within 1e-3, total energy within 1e-4."""
    sc = _box_scene(32, traversal=traversal)
    tc.reset_launch_counts()
    tp.reset_launch_counts()
    img_card = lt.render_lt(sc, 2, paths_per_pass=8192, seed=777,
                            device=cuda).cpu()
    if traversal == "cluster":
        assert tc.closest_launches > 0 and tc.any_launches > 0
        assert tp.closest_launches == 0
    else:
        assert tp.closest_launches > 0 and tp.any_launches > 0
        assert tc.closest_launches == 0
    img_cpu = lt.render_lt(sc, 2, paths_per_pass=8192, seed=777, device="cpu")
    assert torch.isfinite(img_card).all() and float(img_card.sum()) > 0.0
    assert _close_share(img_card, img_cpu) >= 0.99
    e_card, e_cpu = float(img_card.double().sum()), float(img_cpu.double().sum())
    assert abs(e_card - e_cpu) <= 1e-4 * e_cpu


def test_gbuffer_on_card_matches_cpu_twins(cuda):
    """eval_gbuffer on the card through B1/B2 against the CPU twins: float
    layers by the image rule, ids equal on >= 99% of pixels."""
    sc = _box_scene(32)
    tc.reset_launch_counts()
    g_card = gbuffer.eval_gbuffer(sc, 7, n_samples=4, device=cuda)
    assert tc.closest_launches > 0 and tc.any_launches > 0
    g_cpu = gbuffer.eval_gbuffer(sc, 7, n_samples=4, device="cpu")
    for k, v in g_cpu.items():
        if k in ("mat_id", "inst_id"):
            assert float((g_card[k].cpu() == v).float().mean()) >= 0.99, k
        else:
            assert _close_share(g_card[k], v) >= 0.99, k


def test_instanced_gbuffer_on_card(cuda):
    """eval_gbuffer on an instanced scene through B3 in both modes: inst_id
    equal to the flattened layout's on >= 99.9% of pixels."""
    inst, flat = _instanced_scene(), _instanced_scene(instancing="off")
    tc.reset_launch_counts()
    gi = gbuffer.eval_gbuffer(inst, 3, n_samples=4, device=cuda)
    assert tc.inst_closest_launches > 0 and tc.inst_any_launches > 0
    gf = gbuffer.eval_gbuffer(flat, 3, n_samples=4, device=cuda)
    same = float((gi["inst_id"] == gf["inst_id"]).float().mean())
    assert same >= 0.999, same
    assert int(gi["inst_id"].max()) > 0


def test_adaptive_on_card_matches_cpu_twins(cuda):
    """render_adaptive with a top-up (spp_base 33: two base rounds) on the
    card against the CPU twins."""
    sc = _box_scene(16)
    kw = dict(spp_base=33, spp_max=40, seed=3, noise_threshold=0.1,
              tile_pixels=128)
    img_card = gbuffer.render_adaptive(sc, device=cuda, **kw)
    img_cpu = gbuffer.render_adaptive(sc, device="cpu", **kw)
    assert _close_share(torch.tensor(img_card), torch.tensor(img_cpu)) >= 0.99


def test_oracle_reads_a_scene_on_the_card(cuda):
    """The oracle takes its tables off the card (.cpu().numpy())."""
    b = SceneBuilder()
    grey = b.lambert([0.65, 0.65, 0.65])
    b.add_box_interior(2.0, grey, grey, grey, b.lambert([0.7, 0.15, 0.1]), grey)
    b.rect_light([0, 1.95, 0], 0.7, 0.7, [12.0, 11.0, 9.0])
    sc = b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=6, height=4,
                 trace_depth=4)
    a = oracle.OracleLT(sc.to(cuda)).render(n_paths=300, max_depth=4, seed=2)
    c = oracle.OracleLT(sc).render(n_paths=300, max_depth=4, seed=2)
    np.testing.assert_array_equal(a, c)
    r = oracle.OracleRenderer(sc.to(cuda)).render(6, 4, 1, max_depth=3, seed=2)
    assert np.isfinite(r).all() and r.sum() > 0


def test_bdpt_on_card_matches_cpu_twins(cuda):
    """One full SBDPT pass at 32x32, depth 5 (B1 on its camera and light
    wavefronts, B2 on its NEE, t = 1 and inner connections) against the
    CPU twins, strategy by strategy: the same labels, each image by the
    image rule."""
    sc = _box_scene(32)
    tc.reset_launch_counts()
    card = bdpt.strategy_images(sc, 0, 777, 5, "full", device=cuda)
    assert tc.closest_launches == 9 and tc.any_launches == 14
    cpu = bdpt.strategy_images(sc, 0, 777, 5, "full", device="cpu")
    assert sorted(card) == sorted(cpu) and (2, 2) in cpu
    for lbl, img in cpu.items():
        assert torch.isfinite(card[lbl]).all(), lbl
        assert _close_share(card[lbl], img) >= 0.99, lbl


def _same_proposals(card, cpu, what):
    """_mutate on the card and on the CPU: `large` equal, large steps bit
    for bit, small steps within 1e-6 on the circle (a float32 exp)."""
    (u_c, l_c), (u_h, l_h) = card, cpu
    l_c, u_c = l_c.cpu(), u_c.cpu()
    assert torch.equal(l_c, l_h), what
    assert torch.equal(u_c[l_h], u_h[l_h]), what
    d = (u_c - u_h).abs()
    assert float(torch.minimum(d, 1.0 - d).max()) <= 1e-6, what


def _same_accepts(u0, u_card, u_cpu, what):
    """The accept decisions (a chain's vector changed) equal on >= 99.9% of
    chains, and some accepted, some not."""
    a_c = (u_card.cpu() != u0).any(dim=1)
    a_h = (u_cpu != u0).any(dim=1)
    assert 0.0 < float(a_h.float().mean()) < 1.0, what
    assert float((a_c == a_h).float().mean()) >= 0.999, what


def test_mlt_step_on_card_matches_cpu_twins(cuda):
    """One PSSMLT mutation of 32 * 32 * 4 chains at 32x32, depth 5, from one
    chain state (the CPU's burn-in resampling): the proposals, the splat
    image by the image rule, the accept decisions."""
    sc = _box_scene(32)
    R, md, seed, step = 32 * 32 * 4, 5, 777, 3
    state = mlt.init_chains(sc, R, seed, md)
    key = torch.arange(R, dtype=torch.int64)
    _same_proposals(mlt._mutate(state[0].to(cuda), key.to(cuda), step, seed),
                    mlt._mutate(state[0], key, step, seed), "mlt")
    tc.reset_launch_counts()
    card = mlt.mlt_step(sc.to(cuda), torch.zeros((32 * 32, 3), device=cuda),
                        *(x.to(cuda) for x in state), step, seed, md)
    assert tc.closest_launches == md and tc.any_launches == md - 1
    cpu = mlt.mlt_step(sc, torch.zeros((32 * 32, 3)), *state, step, seed, md)
    assert torch.isfinite(card[0]).all() and float(card[0].sum()) > 0.0
    assert _close_share(card[0], cpu[0]) >= 0.99
    _same_accepts(state[0], card[1], cpu[1], "mlt")
    assert float(card[6]) == float(cpu[6])


def test_mmlt_step_on_card_matches_cpu_twins(cuda):
    """One merged MMLT mutation at 32x32, depth 5 (groups k = 2..6, 1,024
    chains each) from one chain state (the CPU's evaluation of uniform
    vectors): the proposals, each group's splat image by the image rule,
    the accept decisions."""
    sc = _box_scene(32)
    md, kmax, seed, step = 5, 6, 777, 5
    ks = list(range(2, kmax + 1))
    lane_k = torch.tensor(ks).repeat_interleave(1024)
    gid = lane_k - 2
    u = mmlt._init_psv(lane_k.shape[0], mmlt.psv_dims(kmax), 0, seed)
    pix, col, f = mmlt._eval_merged(sc, u, lane_k, kmax, md)
    key = torch.arange(u.shape[0], dtype=torch.int64) + 0x9E3779B9
    _same_proposals(mmlt._mutate(u.to(cuda), key.to(cuda), step, seed),
                    mmlt._mutate(u, key, step, seed), "mmlt")
    hw = 32 * 32
    args = (len(ks), kmax, md, 1024.0, 1.0, hw)
    tc.reset_launch_counts()
    card = mmlt._mmlt_step_merged(
        sc.to(cuda), torch.zeros((len(ks) * hw, 3), device=cuda),
        *(x.to(cuda) for x in (u, f, pix, col, lane_k, gid)), step, seed,
        *args)
    assert tc.closest_launches == 2 * md - 1 and tc.any_launches == 14
    cpu = mmlt._mmlt_step_merged(sc, torch.zeros((len(ks) * hw, 3)), u, f,
                                 pix, col, lane_k, gid, step, seed, *args)
    for gi in range(len(ks)):
        sl = slice(gi * hw, (gi + 1) * hw)
        assert torch.isfinite(card[0][sl]).all(), gi
        assert _close_share(card[0][sl], cpu[0][sl]) >= 0.99, gi
    _same_accepts(u, card[1], cpu[1], "mmlt")
    assert torch.equal(card[6].cpu(), cpu[6])



def _front_library(tmp_path, size=32):
    """chip_smoke.py's statefile library (phase 20's settings): the scene of
    scene/library.py with a field of small boxes, the cluster route over a
    flat pool (B1/B2)."""
    from hydracore_tpu_torch.scene.library import write_library

    return write_library(tmp_path / "lib", size, depth=5, spp=16, seed=777,
                         grid=12)


def test_cli_pt_on_card_matches_cpu(cuda, tmp_path):
    """The CLI's pass loop on the card (the default device) against
    device="cpu" at 32x32, 4 spp: the checkpoints' float sums by the image
    rule, B1 and B2 launched."""
    from hydracore_tpu_torch.app import cli
    from hydracore_tpu_torch.utils.checkpoint import load_checkpoint

    lib = _front_library(tmp_path)
    fbs = {}
    for dev in (None, "cpu"):
        ck = str(tmp_path / f"{dev}.npz")
        tc.reset_launch_counts()
        assert cli.main(["-inputlib", lib, "-out", str(tmp_path / f"{dev}.png"),
                         "-spp", "4", "-checkpoint", ck], device=dev) == 0
        if dev is None:
            assert tc.closest_launches > 0 and tc.any_launches > 0
        fb, spp, _ = load_checkpoint(ck)
        assert spp == 4 and np.isfinite(fb).all() and fb.sum() > 0
        fbs[dev] = torch.as_tensor(fb) / 4
    assert _close_share(fbs[None], fbs["cpu"]) >= 0.99


def test_mesh_world_of_one_on_card(cuda, tmp_path):
    """make_mesh on the card: an NCCL world of 1 in this process;
    render_distributed against the same loop on the CPU (gloo) at 32x32,
    4 spp, by the image rule; close() destroys the group."""
    import torch.distributed as dist

    from hydracore_tpu_torch.parallel import mesh as pm
    from hydracore_tpu_torch.scene.scene import load_scene

    sc = load_scene(_front_library(tmp_path))
    mesh = pm.make_mesh()
    try:
        assert (mesh.size, mesh.rank, dist.get_backend()) == (1, 0, "nccl")
        tc.reset_launch_counts()
        card = pm.render_distributed(sc, 4, mesh=mesh, seed=777)
        assert tc.closest_launches > 0
    finally:
        mesh.close()
    assert not dist.is_initialized()
    cpu = pm.render_distributed(sc, 4, seed=777, device="cpu")
    assert _close_share(card.cpu(), cpu) >= 0.99


def test_span_holds_its_kernels_launch_on_the_profilers_clock(cuda):
    """Five spans, each around one torch.cuda._sleep launch with host
    sleeps of 5 ms between them: each holds its launch's runtime event on
    the profiler's clock, and spans.attribute puts each kernel on its
    span."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from hydracore_tpu_torch.utils import spans

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with spans.recording():
            for k in range(5):
                time.sleep(0.005)
                with spans.span(f"sleep{k}"):
                    torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
    got = spans.take()
    ops, launches = spans.device_events(prof)
    kernels = sorted(ops, key=lambda o: -o[2])[:5]
    assert [s.name for s in got.spans] == [f"sleep{k}" for k in range(5)]
    table = spans.attribute(got.spans, ops, launches)
    for s, kernel in zip(got.spans, sorted(kernels, key=lambda o: o[1])):
        t = launches[kernel[3]]
        print(f"{s.name}: launch {(t - s.start) / 1e3:.1f} us after the "
              f"span's start, {(s.end - t) / 1e3:.1f} us before its end")
        assert s.start <= t < s.end
        assert table[s.name]["ops"] == 1
        assert table[s.name]["device_s"] == pytest.approx(kernel[2] / 1e9)


def test_one_nonzero_in_a_span_is_one_sync_at_its_line(cuda, tmp_path):
    """torch's sync debug mode, as recording sets it: one x.nonzero() from
    a frame of the port counts once, at its line and under its span; the
    test's own synchronize counts nothing."""
    import os

    from hydracore_tpu_torch.utils import spans

    x = torch.arange(8, device=cuda) % 2
    where = os.path.join(os.path.dirname(spans.__file__), "sync_probe.py")
    code = compile("\n\ny = x.nonzero()\n", where, "exec")
    with spans.recording():
        with spans.span("probe"):
            exec(code, {"x": x})
        torch.cuda.synchronize()
    got = spans.take()
    site = os.path.relpath(where, os.path.dirname(os.path.dirname(
        os.path.dirname(spans.__file__))))
    assert got.syncs == {(f"{site}:3", "probe"): 1}
    assert torch.cuda.get_sync_debug_mode() == 0


# ---- the dense route's kernel (csrc/traverse_dense.cu) against its plain
# version on the card, every output word equal

def _dense_pair(case, dev, f64, any_hit, t_max=None, active=None):
    """(kernel, plain) outputs of one call on the card; t_max None takes
    the case's per-ray tensor."""
    from hydracore_tpu_torch.ops import traverse_dense as td
    from hydracore_tpu_torch.ops.intersect import ray_args

    tri9f, slot_tri, ro, rd, tm = (x.to(dev) for x in case)
    if t_max is not None:
        tm = t_max.to(dev) if isinstance(t_max, torch.Tensor) else t_max
    act = None if active is None else active.to(dev)
    got = td.traverse_dense(tri9f, slot_tri, ro, rd, tm, act, f64=f64,
                            any_hit_mode=any_hit)
    tm_all, act_all = ray_args(ro, tm, act)
    want = td.traverse_dense_plain(tri9f, slot_tri, ro, rd, tm_all, act_all,
                                   f64)
    return (got, want[1] >= 0) if any_hit else (got, want)


def _dense_equal(got, want) -> bool:
    from dense_cases import same_words

    if isinstance(got, torch.Tensor):
        return same_words(got, want)
    return all(same_words(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("t_max", ["scalar", "tensor", "broadcast"])
@pytest.mark.parametrize("active", ["all", "none", "random"])
def test_dense_kernel_matches_plain(cuda, f64, any_hit, t_max, active):
    """The synthetic case of tests/dense_cases.py: equal-t ties in
    three leaves, padding and degenerate slots, rays parallel to a
    triangle, inf, NaN and zero components, adversarial t_max values per
    ray (or one value: a number, a 0-d tensor); 1,000 rays (not a multiple
    of the block)."""
    from dense_cases import active_mask, dense_case

    case = dense_case(21)
    tm = {"scalar": 1.5, "tensor": None, "broadcast": torch.tensor(1.5)}
    got, want = _dense_pair(case, cuda, f64, any_hit, tm[t_max],
                            active_mask(active, case[2].shape[0]))
    assert _dense_equal(got, want)
    if active != "none":
        assert bool((want if any_hit else want[1] >= 0).any())


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("R", [0, 1, 257])
def test_dense_kernel_matches_plain_on_few_rays(cuda, f64, R):
    from dense_cases import dense_case

    case = tuple(x[:R] if k >= 2 else x
                 for k, x in enumerate(dense_case(22)))
    for any_hit in (False, True):
        got, want = _dense_pair(case, cuda, f64, any_hit)
        assert _dense_equal(got, want)


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_dense_kernel_matches_plain_on_the_cornell_cell(cuda, f64, any_hit):
    """2^20 rays from inside the box in every direction, 3/4 of them live,
    t_max per ray: the cell's scene and wavefront size."""
    from dense_cases import active_mask, cornell_box

    scene = cornell_box()
    assert scene.wbvh_tri9f.shape[0] * 8 == 88
    R = 1 << 20
    g = torch.Generator().manual_seed(5)
    lo, hi = scene.world_bmin.float(), scene.world_bmin + scene.world_bext
    ro = lo + torch.rand((R, 3), generator=g) * (hi - lo)
    rd = torch.randn((R, 3), generator=g)
    tm = torch.where(torch.rand(R, generator=g) < 0.5, 1e30,
                     torch.rand(R, generator=g) * 0.6)
    case = (scene.wbvh_tri9f, scene.wbvh_slot_tri, ro, rd, tm)
    act = active_mask("random", R) | (torch.arange(R) % 4 != 0)
    got, want = _dense_pair(case, cuda, f64, any_hit, active=act)
    assert _dense_equal(got, want)
    hit = want if any_hit else want[1] >= 0
    assert float(hit.float().mean()) > 0.5


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_dense_kernel_matches_plain_above_block_slots(cuda, f64, any_hit):
    """2,104 slots: the plain version's two blocks of BLOCK_SLOTS (its
    float32 rounding of the running best at the first block's end under
    f64), the kernel's three chunks."""
    from hydracore_tpu_torch.ops import traverse_dense as td
    from dense_cases import active_mask, dense_case

    case = dense_case(23, n_slots=2104, n_rays=4099)
    assert case[1].shape[0] > td.BLOCK_SLOTS
    got, want = _dense_pair(case, cuda, f64, any_hit,
                            active=active_mask("random", 4099))
    assert _dense_equal(got, want)


def test_dense_route_named_on_a_scene_above_block_slots(cuda):
    """traversal="dense" named on a scene of more than 2,048 slots: the
    dispatcher's calls on the card equal the plain version's."""
    from hydracore_tpu_torch.ops import trace_api
    from hydracore_tpu_torch.ops import traverse_dense as td
    from hydracore_tpu_torch.ops.intersect import ray_args

    scene = _rects_scene(n=420, traversal="dense").to(cuda)
    assert scene.wbvh_tri9f.shape[0] * 8 > td.BLOCK_SLOTS
    g = torch.Generator().manual_seed(9)
    ro = (torch.rand((65536, 3), generator=g) * 10 - 5).to(cuda)
    rd = torch.randn((65536, 3), generator=g).to(cuda)
    t, tri, u, v = trace_api.closest_hit(scene, ro, rd)
    occ = trace_api.any_hit(scene, ro, rd, 3.0)
    tm, act = ray_args(ro, 1e30, None)
    want = td.traverse_dense_plain(scene.wbvh_tri9f, scene.wbvh_slot_tri, ro,
                                   rd, tm, act)
    assert _dense_equal((t, tri, u, v), want)
    tm, _ = ray_args(ro, 3.0, None)
    _, tri3, _, _ = td.traverse_dense_plain(scene.wbvh_tri9f,
                                            scene.wbvh_slot_tri, ro, rd, tm,
                                            act)
    assert torch.equal(occ, tri3 >= 0) and bool(occ.any())


@pytest.mark.parametrize("t_max", ["scalar", "tensor"])
def test_dense_call_is_one_launch_and_no_host_sync(cuda, t_max):
    """Under torch's sync debug mode "error" the dispatcher's closest and
    any hit on the Cornell cell's scene raise nothing, and each moves its
    launch counter by exactly 1."""
    from dense_cases import cornell_box

    from hydracore_tpu_torch.ops import trace_api
    from hydracore_tpu_torch.ops import traverse_dense as td

    scene = cornell_box().to(cuda)
    R = 4096
    ro = torch.full((R, 3), 0.25, device=cuda)
    rd = torch.randn((R, 3), device=cuda)
    tm = 1e30 if t_max == "scalar" else torch.full((R,), 1e30, device=cuda)
    act = torch.arange(R, device=cuda) % 3 != 0
    torch.cuda.synchronize()
    td.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t, tri, _, _ = trace_api.closest_hit(scene, ro, rd, tm, act)
        assert (td.closest_launches, td.any_launches) == (1, 0)
        occ = trace_api.any_hit(scene, ro, rd, tm, act)
        assert (td.closest_launches, td.any_launches) == (1, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(occ, tri >= 0) and bool(occ.any())
