"""Tests of the port that need an NVIDIA GPU: kernels B1/B2 (flat and
partitioned pools), B3 (instanced pools) and B4 (warp packets over the
8-wide BVH) against their plain twins, the path tracer on the card
against the CPU twins, by the cluster and by the packet route, and the
kernel lab's kernels T1-T7 (hydracore_tpu_torch/tools/) against their
plain versions on the card.

Each test skips without CUDA. The file imports nothing of the JAX package,
so it runs on a machine with the card:

    python -m pytest tests/test_torch_card.py -q

Tolerances: kernel and twin share their arithmetic (no fast math, no FMA
contraction) and, for B4, their packet size and walk order, so t, u, v,
slots, occlusion and visit counts must be equal; the card's image must
agree with the CPU twins' image within 1e-3 on >= 99% of pixels. The lab
kernels round every operation as their plain versions do (separate
multiplies and adds, IEEE division), so their outputs must be equal.
"""
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from hydracore_tpu_torch.integrators import pt
from hydracore_tpu_torch.ops import traverse_cluster as tc
from hydracore_tpu_torch.ops import traverse_packet as tp
from hydracore_tpu_torch.scene import statefile as sf
from hydracore_tpu_torch.scene.procedural import SceneBuilder
from hydracore_tpu_torch.scene.scene import assemble
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


def _instanced_scene(size: int = 32, instancing: str = "force"):
    """40 instances (rotated, non-uniformly scaled, one mirrored) of a mesh
    of 2,000 random triangles over a ground plane, under a sky."""
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
    t_k, s_k = tc.cluster_traverse(blocks, *pool, any_hit_mode=any_hit_mode)
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
    t_k, s_k = tc.cluster_traverse(blocks, *pool, any_hit_mode=any_hit_mode)
    after = (tc.closest_launches, tc.any_launches)
    t_t, s_t = tc.cluster_traverse_plain(blocks, *pool,
                                         any_hit_mode=any_hit_mode)
    t_f, s_f = tc.cluster_traverse(blocks, flat.cl_bounds_oct, flat.cl_tris,
                                   flat.cl_oct_perm, any_hit_mode=any_hit_mode)
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


@pytest.mark.parametrize("any_hit_mode", [False, True])
@pytest.mark.parametrize("r_blk", [tc.R_BLK, tc.R_BLK_BOUNCE])
def test_instanced_kernel_matches_twin(cuda, any_hit_mode, r_blk):
    """B3: world-space boxes, the Woop test in each instance's local space."""
    sc = _instanced_scene().to(cuda)
    assert sc.settings.has_inst and sc.inst_woop.shape[0] == 41
    blocks, R = _random_blocks(cuda, [-14, -1, -14], [14, 6, 14], r_blk, 3.0)
    args = (blocks, sc.cl_bounds_oct, sc.cl_tris, sc.cl_oct_perm)
    kw = dict(any_hit_mode=any_hit_mode, cl_map=sc.cl_map,
              inst_woop=sc.inst_woop)
    before = (tc.inst_closest_launches, tc.inst_any_launches,
              tc.closest_launches, tc.any_launches)
    t_k, s_k = tc.cluster_traverse(*args, **kw)
    after = (tc.inst_closest_launches, tc.inst_any_launches,
             tc.closest_launches, tc.any_launches)
    t_t, s_t = tc.cluster_traverse_plain(*args, **kw)
    torch.cuda.synchronize()
    assert after[int(any_hit_mode)] == before[int(any_hit_mode)] + 1
    assert after[2:] == before[2:]
    hit = s_k >= 0
    assert 100 < int(hit.sum()) < R
    assert torch.equal(hit, s_t >= 0)
    assert torch.equal(t_k, t_t)
    if not any_hit_mode:
        assert float((s_k == s_t).float().mean()) >= 0.999
        inst = sc.cl_slot_tri2[s_k[hit].long(), 1]
        assert int(inst.unique().numel()) > 20  # hits across the instances


def test_wrapper_refuses_mixed_devices(cuda):
    sc = _rects_scene()
    blocks = torch.zeros((2, tc.R_BLK, 8), device=cuda)
    with pytest.raises(ValueError, match="cpu"):
        tc.cluster_traverse(blocks, sc.cl_bounds_oct, sc.cl_tris,
                            sc.cl_oct_perm)


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
    pool, idx = t7.inputs(2000, 512, device=cuda)  # 2000 rows: 250 CTAs
    before = (t7.gather_launches, t7.onehot_launches)
    out_k = t7.gather(pool, idx, onehot=onehot)
    after = (t7.gather_launches, t7.onehot_launches)
    out_p = t7.gather_plain(pool, idx, onehot=onehot)
    torch.cuda.synchronize()
    assert after[int(onehot)] == before[int(onehot)] + 1
    assert after[1 - int(onehot)] == before[1 - int(onehot)]
    assert torch.equal(out_k, out_p)


def test_lab_prim_kernels_match_plain(cuda):
    x, xi = t6.inputs(cuda)
    rng = np.random.default_rng(2)
    xr = torch.tensor(rng.normal(size=t6.SHAPE).astype(np.float32), device=cuda)
    before = t6.prim_launches
    for k in range(1, 11):
        for xx in (x, xr):
            assert torch.equal(t6.prim(k, xx, xi), t6.prim_plain(k, xx, xi)), k
    assert t6.prim_launches == before + 20


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
