"""Two-level instancing in the port: kernel B3's plain twin against the
Pallas kernel, and the instanced layout against the flattened one and
against the JAX package, on the scene of tests/test_instancing.py (a plane
and five transformed boxes under a sky) plus one mirrored box.

Tolerances:
  * B3 twin vs the Pallas kernel in inst_mode (interpret mode): equal hit
    masks, t within rtol 1e-4 (the TPU kernel keeps the winning lane in t's
    low 7 mantissa bits, and folds the instance matrix into the Woop block
    where the twin moves the ray: the same function, rounded differently),
    slots equal on > 98% of hits (ties on shared edges may pick either
    triangle), occlusion equal;
  * closest_hit / compute_hit, instanced vs flattened and port vs JAX (the
    criteria of tests/test_instancing.py): hit masks equal on > 99.9% of
    rays, t within rtol/atol 1e-3, world position within 2e-3, normal
    cosine > 0.999, materials equal;
  * render(spp=4, seed=3): >= 99% of pixels within 1e-3 of the JAX render
    (the tolerance of tests/test_torch_pt.py), instanced vs flattened MSE
    < 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore_tpu.integrators import pt as jpt
from hydracore_tpu.ops import trace_api as jtrace
from hydracore_tpu.ops import traverse_cluster as jtc
from hydracore_tpu.scene import scene as jscene
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.ops import trace_api
from hydracore_tpu_torch.ops import traverse_cluster as tc
from hydracore_tpu_torch.scene import scene as pscene
from tests.test_torch_assemble import JAX, PORT, make_desc, xform
from tests.test_torch_scene import to_port

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)

SIZE = 32


def _desc(pkg):
    desc = make_desc(pkg, False, SIZE)
    # a mirrored, non-uniformly scaled box: negative determinant
    desc.instances.append(pkg[0].InstanceDesc(
        mesh_id=2, matrix=xform(-4.5, 0.3, 3.0, 0.8, 0.4, sx=-1.5)))
    return desc


@pytest.fixture(scope="module")
def scenes():
    """(JAX instanced, port instanced, port flattened) of the same desc."""
    js = jscene.assemble(_desc(JAX), instancing="force")
    inst = pscene.assemble(_desc(PORT), instancing="force")
    flat = pscene.assemble(_desc(PORT), instancing="off")
    assert inst.settings.has_inst and not flat.settings.has_inst
    assert flat.num_triangles == 2 + 6 * 12 and inst.num_triangles == 2 + 12
    return js, inst, flat


def _camera_rays(scene):
    ys, xs = np.mgrid[0:SIZE, 0:SIZE]
    half = torch.full((SIZE * SIZE, 2), 0.5)
    return tpt.make_eye_rays(scene.camera, torch.tensor(xs.reshape(-1)),
                             torch.tensor(ys.reshape(-1)), half, half)


@pytest.fixture(scope="module")
def rays(scenes):
    """512 random rays around the boxes and 512 camera rays."""
    rng = np.random.default_rng(9)
    ro = rng.uniform([-6, -0.9, -4], [6, 3, 5], (512, 3)).astype(np.float32)
    rd = rng.normal(size=(512, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    co, cd = _camera_rays(scenes[1])
    pick = rng.choice(SIZE * SIZE, 512, replace=False)
    return (np.concatenate([ro, co.numpy()[pick]]),
            np.concatenate([rd, cd.numpy()[pick]]))


@pytest.mark.parametrize("any_hit_mode", [False, True])
def test_b3_twin_matches_pallas_kernel(scenes, rays, any_hit_mode):
    js, inst, _ = scenes
    ro, rd = rays
    t_lim = np.where(np.arange(ro.shape[0]) % 3 == 0, 9.0, 1e30)
    act = np.arange(ro.shape[0]) % 5 != 0
    blocks, R = jtc._to_blocks(jnp.asarray(ro), jnp.asarray(rd),
                               jnp.asarray(t_lim, jnp.float32),
                               jnp.asarray(act), 256)
    t_j, s_j, _ = jtc._cluster_traverse(
        blocks, jnp.asarray(js.cl_bounds_oct), jnp.asarray(js.cl_tris),
        jnp.asarray(js.cl_oct_perm), jnp.asarray(js.cl_map),
        jnp.asarray(js.inst_woop), any_hit_mode=any_hit_mode, interpret=True)
    t_p, s_p = tc.cluster_traverse(
        torch.tensor(np.asarray(blocks)), inst.cl_bounds_oct, inst.cl_tris,
        inst.cl_oct_perm, any_hit_mode=any_hit_mode, cl_map=inst.cl_map,
        inst_woop=inst.inst_woop)
    s_j, s_p = np.asarray(s_j).ravel()[:R], s_p.numpy().ravel()[:R]
    h_j, h_p = s_j >= 0, s_p >= 0
    assert np.array_equal(h_j, h_p)
    assert 100 < h_p.sum() < h_p.size
    assert not h_p[~act].any()
    if not any_hit_mode:
        t_j, t_p = np.asarray(t_j).ravel()[:R], t_p.numpy().ravel()[:R]
        np.testing.assert_allclose(t_p[h_p], t_j[h_j], rtol=1e-4)
        assert (s_p[h_p] == s_j[h_j]).mean() > 0.98
        assert (t_p[h_p] < t_lim[h_p]).all()
        # slots name instance-clusters: every instance is hit by some ray
        hit_inst = inst.cl_slot_tri2[torch.tensor(s_p[h_p]).long(), 1]
        assert sorted(set(hit_inst.tolist())) == list(range(7))


def test_wrapper_checks_instanced_inputs(scenes):
    _, inst, flat = scenes
    blocks = torch.zeros((1, 256, 8))
    pool = (inst.cl_bounds_oct, inst.cl_tris, inst.cl_oct_perm)
    with pytest.raises(ValueError, match="come together"):
        tc.cluster_traverse(blocks, *pool, cl_map=inst.cl_map)
    with pytest.raises(ValueError, match="cl_map must be"):
        tc.cluster_traverse(blocks, *pool, cl_map=inst.cl_map[:, :64],
                            inst_woop=inst.inst_woop)
    with pytest.raises(TypeError, match="cl_map"):
        tc.cluster_traverse(blocks, *pool, cl_map=inst.cl_map.long(),
                            inst_woop=inst.inst_woop)
    with pytest.raises(ValueError, match="not partitioned"):
        tc.cluster_traverse(blocks, inst.cl_bounds_oct[None],
                            inst.cl_tris[None], inst.cl_oct_perm[None],
                            cl_map=inst.cl_map, inst_woop=inst.inst_woop)
    # an inactive block hits nothing in either layout
    for sc in (inst, flat):
        assert not bool(tc.any_hit(sc, torch.zeros((3, 3)), torch.ones((3, 3)),
                                   1e30, active=torch.zeros(3, dtype=torch.bool)
                                   ).any())


def _hits(scene, ro, rd):
    t, tri, u, v = trace_api.closest_hit(scene, ro, rd)
    return t, tri, tpt.compute_hit(scene, tri, u, v, ro, rd, t)


def _assert_same_hits(a, b):
    (ta, tria, pa), (tb, trib, pb) = a, b
    ha, hb = np.asarray(tria) >= 0, np.asarray(trib) >= 0
    assert (ha == hb).mean() > 0.999  # grazing-edge disagreements only
    both = ha & hb
    assert both.sum() > 200
    assert np.allclose(np.asarray(ta)[both], np.asarray(tb)[both],
                       rtol=1e-3, atol=1e-3)
    assert np.allclose(np.asarray(pa[0])[both], np.asarray(pb[0])[both],
                       atol=2e-3)
    ncos = np.sum(np.asarray(pa[1])[both] * np.asarray(pb[1])[both], axis=1)
    assert ncos.min() > 0.999
    assert (np.asarray(pa[4])[both] == np.asarray(pb[4])[both]).all()


def test_closest_hit_instanced_matches_flat(scenes):
    """Primary hits: the same t / world position / normal / material under
    both layouts (tests/test_instancing.py inside the port)."""
    _, inst, flat = scenes
    ro, rd = _camera_rays(flat)
    hi, hf = _hits(inst, ro, rd), _hits(flat, ro, rd)
    _assert_same_hits(hi, hf)
    # the instanced id is a slot: it resolves to (mesh triangle, instance)
    hit = hi[1] >= 0
    row = inst.cl_slot_tri2[hi[1][hit]]
    assert int(row[:, 0].max()) < inst.num_triangles
    assert set(row[:, 1].tolist()) <= set(range(7))
    assert (hi[1][~hit] == -1).all() and torch.isinf(hi[0][~hit]).all()
    # shadow rays from the hit points towards the sky agree too
    so = hf[2][0] + 1e-3 * hf[2][2]
    up = torch.tensor([[0.3, 1.0, 0.2]]).expand_as(so).contiguous()
    occ_i = trace_api.any_hit(inst, so, up, 50.0, active=hit)
    occ_f = trace_api.any_hit(flat, so, up, 50.0, active=hit)
    assert float((occ_i == occ_f).float().mean()) > 0.999 and bool(occ_f.any())


def test_instanced_hits_match_jax(scenes):
    js, inst, _ = scenes
    ro, rd = _camera_rays(inst)
    jo, jd = jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy())
    tj, trij, uj, vj = jtrace.closest_hit(js, jo, jd)
    pj = jpt.compute_hit(js, trij, uj, vj, jo, jd, tj)
    _assert_same_hits(_hits(inst, ro, rd), (tj, trij, pj))
    # the port runs the very bytes of the JAX scene too
    tp, trip, _, _ = trace_api.closest_hit(to_port(js), ro, rd)
    ti, trii, _, _ = trace_api.closest_hit(inst, ro, rd)
    assert torch.equal(trip, trii) and torch.equal(tp, ti)


def test_instanced_render_matches_jax_and_flat(scenes):
    js, inst, flat = scenes
    img_j = np.asarray(jpt.render(js, spp=4, seed=3))
    img_i = tpt.render(inst, spp=4, seed=3, device="cpu").numpy()
    img_f = tpt.render(flat, spp=4, seed=3, device="cpu").numpy()
    assert img_i.shape == (SIZE, SIZE, 3) and np.isfinite(img_i).all()
    assert img_i.mean() > 0.01
    agree = (np.abs(img_i - img_j).max(axis=-1) <= 1e-3).mean()
    assert agree >= 0.99, agree
    assert float(((img_i - img_f) ** 2).mean()) < 1e-4
