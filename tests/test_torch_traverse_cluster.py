"""Cluster traversal of the port (kernels B1/B2 and their plain twin)
against the JAX package, on tests/test_traverse_cluster.py's 350-rect scene.

Tolerances:
  * twin vs the Pallas kernel (interpret mode): equal hit masks, t within
    rtol 1e-4 (the TPU kernel keeps the winning lane in t's low 7 mantissa
    bits, ~1e-5 relative), slots equal on > 98% of hits (ties on shared
    edges may pick either triangle), occlusion equal;
  * closest_hit / any_hit vs traverse_wide: the criteria of
    tests/test_traverse_cluster.py (equal hit masks, t rtol 1e-4, same
    triangle on > 98% of hits, u within 1e-3 where the triangle agrees);
The kernel-against-twin cases run on the card from tests/test_torch_card.py,
which imports nothing of the JAX package so that it runs on a GPU machine.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore_tpu.bvh.builder import build_bvh as jax_build_bvh
from hydracore_tpu.bvh.clusters import cut_clusters as jax_cut_clusters
from hydracore_tpu.ops import traverse_cluster as jtc
from hydracore_tpu.ops import traverse_wide as jtw
from hydracore_tpu.scene.procedural import SceneBuilder as JaxBuilder
from hydracore_tpu_torch.bvh.builder import build_bvh
from hydracore_tpu_torch.bvh.clusters import cut_clusters
from hydracore_tpu_torch.ops import trace_api
from hydracore_tpu_torch.ops import traverse_cluster as tc
from tests.test_torch_scene import build_with, rects_recipe, to_port

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    js = build_with(JaxBuilder, rects_recipe)
    return js, to_port(js)


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(3)
    R = 256 * 3
    ro = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


@pytest.mark.parametrize("any_hit_mode", [False, True])
def test_twin_matches_pallas_kernel(scenes, rays, any_hit_mode):
    js, ps = scenes
    ro, rd = rays
    t_lim = np.where(np.arange(ro.shape[0]) % 3 == 0, 4.0, 1e30)
    act = np.arange(ro.shape[0]) % 5 != 0
    blocks, R = jtc._to_blocks(jnp.asarray(ro), jnp.asarray(rd),
                               jnp.asarray(t_lim, jnp.float32),
                               jnp.asarray(act), 256)  # padded to 1024
    t_j, s_j, _ = jtc._cluster_traverse(
        blocks, js.cl_bounds_oct, jnp.asarray(js.cl_tris),
        jnp.asarray(js.cl_oct_perm), any_hit_mode=any_hit_mode,
        interpret=True)
    t_p, s_p = tc.cluster_traverse(torch.tensor(np.asarray(blocks)),
                                   ps.cl_bounds_oct, ps.cl_tris,
                                   ps.cl_oct_perm, any_hit_mode=any_hit_mode)
    s_j, s_p = np.asarray(s_j).ravel()[:R], s_p.numpy().ravel()[:R]
    h_j, h_p = s_j >= 0, s_p >= 0
    assert np.array_equal(h_j, h_p)
    assert 50 < h_p.sum() < h_p.size
    assert not h_p[~act].any()
    if not any_hit_mode:
        t_j, t_p = np.asarray(t_j).ravel()[:R], t_p.numpy().ravel()[:R]
        np.testing.assert_allclose(t_p[h_p], t_j[h_j], rtol=1e-4)
        assert (s_p[h_p] == s_j[h_j]).mean() > 0.98
        assert (t_p[h_p] < t_lim[h_p]).all()


def test_closest_matches_wide(scenes, rays):
    js, ps = scenes
    ro, rd = rays
    t_c, tri_c, u_c, _ = trace_api.closest_hit(ps, torch.tensor(ro),
                                               torch.tensor(rd))
    t_w, tri_w, u_w, _ = jtw.closest_hit(js, jnp.asarray(ro), jnp.asarray(rd))
    tri_c, tri_w = tri_c.numpy(), np.asarray(tri_w)
    hit_c, hit_w = tri_c >= 0, tri_w >= 0
    assert np.array_equal(hit_c, hit_w)
    np.testing.assert_allclose(t_c.numpy()[hit_c], np.asarray(t_w)[hit_w],
                               rtol=1e-4)
    same = tri_c == tri_w
    assert same[hit_c].mean() > 0.98
    np.testing.assert_allclose(u_c.numpy()[same & hit_c],
                               np.asarray(u_w)[same & hit_c], atol=1e-3)
    assert np.isinf(t_c.numpy()[~hit_c]).all()


def test_anyhit_matches_wide(scenes, rays):
    js, ps = scenes
    ro, rd = rays
    occ_p = trace_api.any_hit(ps, torch.tensor(ro), torch.tensor(rd), 6.0)
    occ_w = np.asarray(jtw.any_hit(js, jnp.asarray(ro), jnp.asarray(rd), 6.0))
    assert np.array_equal(occ_p.numpy(), occ_w)
    # the coherence-sorted entry points return caller order
    occ_s = trace_api.any_hit_sorted(ps, torch.tensor(ro), torch.tensor(rd), 6.0)
    assert np.array_equal(occ_s.numpy(), occ_w)
    t_s, tri_s, _, _ = trace_api.closest_hit_sorted(ps, torch.tensor(ro),
                                                    torch.tensor(rd))
    t_c, tri_c, _, _ = trace_api.closest_hit(ps, torch.tensor(ro),
                                             torch.tensor(rd))
    assert torch.equal(tri_s, tri_c)


def test_active_mask_and_tmax(scenes, rays):
    _, ps = scenes
    ro, rd = rays
    act = np.zeros(ro.shape[0], bool)
    act[::2] = True
    t, tri, _, _ = trace_api.closest_hit(ps, torch.tensor(ro), torch.tensor(rd),
                                         t_max=4.0, active=torch.tensor(act))
    tri, t = tri.numpy(), t.numpy()
    assert (tri[~act] == -1).all()
    assert (tri[act] >= 0).any()
    assert (t[tri >= 0] < 4.0 + 1e-5).all()
    occ = trace_api.any_hit(ps, torch.tensor(ro), torch.tensor(rd), 4.0,
                            active=torch.tensor(act)).numpy()
    assert not occ[~act].any()
    assert np.array_equal(occ[act], tri[act] >= 0)


def test_cut_clusters_bit_exact():
    rng = np.random.default_rng(0)
    T = 700
    v0 = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    e1 = rng.uniform(-0.1, 0.1, (T, 3)).astype(np.float32)
    e2 = rng.uniform(-0.1, 0.1, (T, 3)).astype(np.float32)
    e2[::50] = e1[::50] * 2.0  # degenerate triangles: rows that never hit
    jb = jax_build_bvh(v0, v0 + e1, v0 + e2)
    pb = build_bvh(v0, v0 + e1, v0 + e2)
    assert np.array_equal(jb.perm, pb.perm)
    p = pb.perm
    jc = jax_cut_clusters(jb, v0[p], e1[p], e2[p])
    pc = cut_clusters(pb, v0[p], e1[p], e2[p])
    for f in ("bounds_lane", "tris", "slot_tri", "oct_perm", "bounds_oct"):
        a, b = getattr(jc, f), getattr(pc, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert jc.num_clusters == pc.num_clusters


def test_moller_trumbore_and_refine():
    """ops/intersect against the JAX package's in f32 (rtol 1e-5, atol
    1e-6), and the f64 (-double_rt) refinement against the same formula in
    numpy float64 rounded to f32 (the JAX side needs process-wide x64)."""
    from hydracore_tpu.ops import intersect as jis
    from hydracore_tpu_torch.ops import intersect as tis

    rng = np.random.default_rng(21)
    n = 4096
    ro, v0 = (rng.uniform(-1, 1, (n, 3)).astype(np.float32) for _ in range(2))
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    e1, e2 = (rng.uniform(-1, 1, (n, 3)).astype(np.float32) for _ in range(2))
    args_j = [jnp.asarray(x) for x in (ro, rd, v0, e1, e2)]
    args_t = [torch.tensor(x) for x in (ro, rd, v0, e1, e2)]
    tj, uj, vj, hj = jis.moller_trumbore(*args_j)
    tt, ut, vt, ht = tis.moller_trumbore(*args_t)
    hit = ht.numpy()
    assert np.array_equal(hit, np.asarray(hj)) and hit.any()
    # on hits (the only pairs the epilogue refines); misses include
    # near-parallel pairs whose t, u, v are ill-conditioned
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(tj)[hit],
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(tis.mt_refine(*args_t), jis.mt_refine(*args_j)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-5, atol=1e-6)

    o, d, p0, a1, a2 = (x.astype(np.float64) for x in (ro, rd, v0, e1, e2))
    p = np.cross(d, a2)
    det = (a1 * p).sum(-1)
    inv = np.where(np.abs(det) > 1e-24, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    sv = o - p0
    q = np.cross(sv, a1)
    ref = [((a2 * q).sum(-1) * inv), ((sv * p).sum(-1) * inv),
           ((d * q).sum(-1) * inv)]
    for a, b in zip(tis.mt_refine(*args_t, f64=True), ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.astype(np.float32), rtol=1e-5,
                                   atol=1e-6)
