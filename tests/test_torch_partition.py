"""Partitioned cluster pools: the port's partition_clusters and chunk-chained
traversal twin against the JAX package.

tests/test_traverse_partition.py holds the JAX chain against the wide BVH
on a reference scene that is not in the repository; here a cornell box
with a sphere of 16,128 triangles (about 200 clusters) is partitioned at a
cap of 128 clusters into two chunks by both packages.

Tolerances:
  * partition_clusters and the partitioned SceneBuilder leaves: bit-exact;
  * chain twin vs _partitioned_traverse (Pallas kernel per chunk, interpret
    mode): equal hit masks, t within rtol 1e-4 (the TPU kernel keeps the
    winning lane in t's low 7 mantissa bits), slots equal on > 98% of hits
    (ties, and the lane bits in the t the JAX chain threads from chunk to
    chunk), occlusion equal;
  * partitioned twin vs the flat twin of the same pool: equal hit masks,
    equal t on >= 99.9% of hits (another visit order may resolve a tie
    between two triangles differently);
  * partitioned render vs flat render at equal seed: MSE < 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.golden_scenes as gs
from hydracore_tpu.bvh.builder import build_bvh as jax_build_bvh
from hydracore_tpu.bvh.clusters import cut_clusters as jax_cut_clusters
from hydracore_tpu.bvh.clusters import partition_clusters as jax_partition
from hydracore_tpu.ops import traverse_cluster as jtc
from hydracore_tpu.scene.procedural import SceneBuilder as JaxBuilder
from hydracore_tpu_torch.bvh.builder import build_bvh
from hydracore_tpu_torch.bvh.clusters import (cut_clusters, maybe_partition,
                                              partition_clusters)
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.ops import trace_api
from hydracore_tpu_torch.ops import traverse_cluster as tc
from hydracore_tpu_torch.scene.procedural import SceneBuilder as PortBuilder
from hydracore_tpu_torch.scene.scene import scene_leaves
from tests.test_torch_scene import (_assert_same_leaves, build_with,
                                    jax_leaves, rects_recipe, to_port)

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)

CAP = 128


def sphere_box(builder, part_cap=None, size=16):
    """Cornell box with a finely tessellated sphere: more than CAP clusters."""
    b = builder()
    m = b.lambert([0.65, 0.65, 0.65])
    b.add_box_interior(2.0, m, m, m, b.lambert([0.7, 0.12, 0.1]),
                       b.lambert([0.12, 0.55, 0.18]))
    b.add_sphere([-0.3, -0.9, 0.0], 1.0, b.lambert([0.5, 0.5, 0.7]),
                 n_seg=128, n_ring=64)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [12.0] * 3)
    kw = {} if part_cap is None else {"part_cap": part_cap}
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=size,
                   height=size, trace_depth=3, **kw)


@pytest.fixture(scope="module")
def scenes():
    """(JAX partitioned scene, the port's partitioned scene, its flat twin)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HYDRA_CL_PART_CAP", str(CAP))
    try:
        js = sphere_box(JaxBuilder)
    finally:
        mp.undo()
    return js, sphere_box(PortBuilder, CAP), sphere_box(PortBuilder)


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(5)
    R = 1024
    ro = rng.uniform(-1.9, 1.9, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def test_partition_clusters_bit_exact():
    """The 350-rect recipe's triangles cut into clusters of 2 (several
    chunks of 128 clusters), partitioned by both packages."""
    sc = build_with(PortBuilder, rects_recipe)
    v0, e1, e2 = (x.numpy() for x in (sc.tri_v0, sc.tri_e1, sc.tri_e2))
    jb = jax_build_bvh(v0, v0 + e1, v0 + e2)
    pb = build_bvh(v0, v0 + e1, v0 + e2)
    p = pb.perm
    jc = jax_partition(jax_cut_clusters(jb, v0[p], e1[p], e2[p], k_tris=2), CAP)
    flat = cut_clusters(pb, v0[p], e1[p], e2[p], k_tris=2)
    pc = partition_clusters(flat, CAP)
    assert pc.tris.shape[0] >= 2 and pc.tris.shape[1:] == (CAP, 4, 384)
    for f in ("bounds_lane", "bounds_sub", "tris", "slot_tri", "oct_perm",
              "bounds_oct"):
        a, b = getattr(jc, f), getattr(pc, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert jc.num_clusters == pc.num_clusters
    # every triangle keeps one slot; a pool within the cap stays flat
    ids = pc.slot_tri[pc.slot_tri >= 0]
    assert np.array_equal(np.sort(ids), np.arange(v0.shape[0]))
    assert maybe_partition(flat, flat.tris.shape[0]) is flat
    assert maybe_partition(flat, CAP).tris.ndim == 4
    with pytest.raises(ValueError, match="multiple of 128"):
        partition_clusters(flat, 100)


def test_partitioned_builder_leaves_bit_exact(scenes):
    js, ps, flat = scenes
    assert ps.cl_tris.dim() == 4 and ps.cl_tris.shape[:2] == (2, CAP)
    assert flat.cl_tris.dim() == 3
    _assert_same_leaves(jax_leaves(js), scene_leaves(ps))
    # scene_from_arrays takes the partitioned JAX scene as it is
    _assert_same_leaves(scene_leaves(ps), scene_leaves(to_port(js)))


@pytest.mark.parametrize("any_hit_mode", [False, True])
def test_chain_twin_matches_jax_chain(scenes, rays, any_hit_mode):
    js, ps, _ = scenes
    ro, rd = rays
    t_lim = np.where(np.arange(ro.shape[0]) % 3 == 0, 2.5, 1e30)
    act = np.arange(ro.shape[0]) % 5 != 0
    blocks, R = jtc._to_blocks(jnp.asarray(ro), jnp.asarray(rd),
                               jnp.asarray(t_lim, jnp.float32),
                               jnp.asarray(act), 256)
    t_j, s_j = jtc._partitioned_traverse(js, blocks, jnp.asarray(js.cl_tris),
                                         any_hit_mode, True, r_blk=256)
    t_p, s_p = tc.cluster_traverse(torch.tensor(np.asarray(blocks)),
                                   ps.cl_bounds_oct, ps.cl_tris,
                                   ps.cl_oct_perm, any_hit_mode=any_hit_mode)
    s_j, s_p = np.asarray(s_j).ravel()[:R], s_p.numpy().ravel()[:R]
    h_j, h_p = s_j >= 0, s_p >= 0
    assert np.array_equal(h_j, h_p)
    assert 100 < h_p.sum() < h_p.size
    assert not h_p[~act].any()
    # hits in both chunks: slots carry the chunk offset
    assert (s_p[h_p] < CAP * 128).any() and (s_p[h_p] >= CAP * 128).any()
    if not any_hit_mode:
        t_j, t_p = np.asarray(t_j).ravel()[:R], t_p.numpy().ravel()[:R]
        np.testing.assert_allclose(t_p[h_p], t_j[h_j], rtol=1e-4)
        assert (s_p[h_p] == s_j[h_j]).mean() > 0.98
        assert (t_p[h_p] < t_lim[h_p]).all()


def test_partitioned_twin_matches_flat_twin(scenes, rays):
    _, ps, flat = scenes
    ro, rd = (torch.tensor(x) for x in rays)
    t_p, tri_p, u_p, _ = trace_api.closest_hit(ps, ro, rd)
    t_f, tri_f, u_f, _ = trace_api.closest_hit(flat, ro, rd)
    hit = tri_f >= 0
    assert torch.equal(tri_p >= 0, hit) and 100 < int(hit.sum())
    assert float((t_p[hit] == t_f[hit]).float().mean()) >= 0.999
    assert float((tri_p[hit] == tri_f[hit]).float().mean()) >= 0.999
    for t_max in (1.5, 6.0):
        occ_p = trace_api.any_hit(ps, ro, rd, t_max)
        occ_f = trace_api.any_hit(flat, ro, rd, t_max)
        assert torch.equal(occ_p, occ_f) and bool(occ_f.any())
    # the coherence-sorted entry points return caller order
    assert torch.equal(trace_api.closest_hit_sorted(ps, ro, rd)[1], tri_p)


def test_partitioned_render_matches_flat(scenes):
    _, ps, flat = scenes
    img_p = tpt.render(ps, spp=4, seed=3, device="cpu").numpy()
    img_f = tpt.render(flat, spp=4, seed=3, device="cpu").numpy()
    assert img_p.shape == (16, 16, 3) and np.isfinite(img_p).all()
    assert img_p.mean() > 0.01
    assert float(((img_p - img_f) ** 2).mean()) < 1e-4


def test_golden_recipe_partitions_only_past_the_cap():
    """A golden recipe (a dozen clusters) keeps its flat pool at any cap."""
    sc = build_with(PortBuilder, gs.scene_mirror_sphere)
    assert sc.cl_tris.dim() == 3 and sc.cl_bounds.shape == (8, 128)
