"""The port's wide BVH (bvh/wide.py), packet pools (pack_pools) and its two
plain traversals over them, traverse_wide and traverse_dense, against the
JAX package on the same scene bytes and the same rays.

Tolerances:
  * collapse_wide and pack_pools: every array bit-exact (tolerance 0), on
    the 350-rect scene of tests/test_traverse_packet.py and on a one-leaf
    scene;
  * traverse_wide and traverse_dense (single block, blocked, f64) against
    the JAX functions of the same name: equal hit masks, t within rtol 1e-4,
    u and v within rtol 1e-3 / atol 1e-4, the same triangle on > 99.9% of
    hits (both walk the same slots in the same order, so only an ulp-level
    difference of a fused multiply-add can move a tie). JAX runs without
    x64 here, so its f64 flag computes in float32; the port's float64
    result must still agree within the same tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.golden_scenes as gs
from hydracore_tpu.bvh.native import build_bvh_auto as jax_build_bvh_auto
from hydracore_tpu.bvh.wide import collapse_wide as jax_collapse_wide
from hydracore_tpu.ops import traverse_dense as jtd
from hydracore_tpu.ops import traverse_packet as jtp
from hydracore_tpu.ops import traverse_wide as jtw
from hydracore_tpu.scene.procedural import SceneBuilder as JaxBuilder
from hydracore_tpu_torch.bvh import wide as pwide
from hydracore_tpu_torch.bvh.native import build_bvh_auto
from hydracore_tpu_torch.ops import traverse_dense as ptd
from hydracore_tpu_torch.ops import traverse_packet as ptp
from hydracore_tpu_torch.ops import traverse_wide as ptw
from tests.test_torch_scene import build_with, rects_recipe, to_port

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)


def _rect_tris(n):
    """Triangles of n random rects (the recipe of rects_recipe), unordered."""
    rng = np.random.default_rng(7)
    v0, v1, v2 = [], [], []
    for _ in range(n):
        c = rng.uniform(-4, 4, 3)
        vx = rng.uniform(-0.4, 0.4, 3)
        vy = rng.uniform(-0.4, 0.4, 3)
        q = [c - vx - vy, c + vx - vy, c + vx + vy, c - vx + vy]
        v0 += [q[0], q[0]]
        v1 += [q[1], q[2]]
        v2 += [q[2], q[3]]
    return (np.asarray(a, np.float32) for a in (v0, v1, v2))


@pytest.mark.parametrize("n_rects", [350, 1])
def test_collapse_wide_and_pack_pools_bit_exact(n_rects):
    v0, v1, v2 = _rect_tris(n_rects)
    jb = jax_build_bvh_auto(v0, v1, v2)
    pb = build_bvh_auto(v0, v1, v2)
    assert np.array_equal(jb.perm, pb.perm)
    p = pb.perm
    args = (v0[p], (v1 - v0)[p], (v2 - v0)[p])
    jw = jax_collapse_wide(jb, *args)
    pw = pwide.collapse_wide(pb, *args)
    if n_rects == 1:  # two triangles: the root is a leaf
        assert pb.count[0] > 0 and pw.num_nodes == 1 and pw.max_depth == 1
    else:
        assert pw.num_nodes > 8 and pw.max_depth >= 3
    assert (pw.max_depth, pw.num_nodes, pw.num_blocks) == \
        (jw.max_depth, jw.num_nodes, jw.num_blocks)
    for name in ("nodes", "tri9", "tri9f", "slot_tri"):
        a, b = getattr(jw, name), getattr(pw, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert (pwide.WIDTH, pwide.LEAF_SIZE, pwide.EMPTY_PAYLOAD) == (8, 8, -(2 ** 30))
    # empty child slots: NaN boxes under the EMPTY payload, never one alone
    pay = pw.nodes[:, :, 6].view(np.int32)
    assert np.array_equal(pay == pwide.EMPTY_PAYLOAD, np.isnan(pw.nodes[:, :, 0]))

    jn, jni, jt = jtp.pack_pools(jw.nodes, jw.tri9f, jw.max_depth)
    pn, pt_ = ptp.pack_pools(pw.nodes, pw.tri9f, pw.max_depth)
    assert pn.shape[0] % 8 == 0 and pt_.shape[0] % 8 == 0
    assert jn.tobytes() == pn.tobytes() and jt.tobytes() == pt_.tobytes()
    # the port reads the payload through a view of the one node array
    assert jni.tobytes() == pn.view(np.int32).tobytes()


def test_pack_pools_refuses_a_tree_deeper_than_the_stack():
    nodes = np.zeros((1, 8, 8), np.float32)
    tri9f = np.zeros((1, 128), np.float32)
    deepest = (ptp.STACK_D - 9) // 7
    ptp.pack_pools(nodes, tri9f, deepest)
    with pytest.raises(ValueError, match="STACK_D"):
        ptp.pack_pools(nodes, tri9f, deepest + 1)


@pytest.fixture(scope="module")
def scenes():
    js = build_with(JaxBuilder, rects_recipe)
    return js, to_port(js)


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(3)
    R = 2048
    ro = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _same_hits(port, jax_out, min_hits=50):
    """The stated tolerances on (t, tri, u, v) of the port against JAX."""
    t_p, tri_p, u_p, v_p = (x.numpy() for x in port)
    t_j, tri_j, u_j, v_j = (np.asarray(x) for x in jax_out)
    assert t_p.dtype == np.float32 and u_p.dtype == np.float32
    h = np.isfinite(t_j)
    assert np.array_equal(np.isfinite(t_p), h)
    assert np.array_equal(tri_p >= 0, h)
    assert min_hits < h.sum() < h.size
    np.testing.assert_allclose(t_p[h], t_j[h], rtol=1e-4)
    same = tri_p[h] == tri_j[h]
    assert same.mean() > 0.999
    np.testing.assert_allclose(u_p[h][same], u_j[h][same], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(v_p[h][same], v_j[h][same], rtol=1e-3, atol=1e-4)
    return h


CASES = {
    "plain": dict(),
    "t_max": dict(t_max=4.0),
    "active": dict(active=np.arange(2048) % 3 != 0),
}


def _kw(case, to):
    kw = dict(CASES[case])
    if "active" in kw:
        kw["active"] = to(kw["active"])
    return kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_traverse_wide_matches_jax(scenes, rays, case):
    js, ps = scenes
    ro, rd = rays
    out_j = jtw.closest_hit(js, jnp.asarray(ro), jnp.asarray(rd),
                            **_kw(case, jnp.asarray))
    out_p = ptw.closest_hit(ps, torch.tensor(ro), torch.tensor(rd),
                            **_kw(case, torch.tensor))
    h = _same_hits(out_p, out_j)
    if case == "t_max":
        assert (out_p[0].numpy()[h] < 4.0).all()
    if case == "active":
        assert not h[~CASES["active"]["active"]].any()
    occ_j = np.asarray(jtw.any_hit(js, jnp.asarray(ro), jnp.asarray(rd), 6.0))
    occ_p = ptw.any_hit(ps, torch.tensor(ro), torch.tensor(rd), 6.0).numpy()
    assert np.array_equal(occ_p, occ_j) and 50 < occ_p.sum() < occ_p.size


def test_traverse_wide_grows_its_register_bank(scenes):
    _, ps = scenes
    nodes2, _, _, k_regs = ptw._prep(ps)
    assert nodes2.shape == (ps.wbvh_nodes.shape[0], 64)
    assert k_regs == ptw.K_REGS and ps.wbvh_depth < ptw.K_REGS
    import dataclasses
    deep = dataclasses.replace(ps, wbvh_depth=40)
    assert ptw._prep(deep)[3] == 40


def _dense_scene(name):
    js = build_with(JaxBuilder, gs.SCENES[name])
    return js, to_port(js)


@pytest.mark.parametrize("name,f64", [
    ("cornell_diffuse", False),  # 32 slots: one block
    ("rects350", False),         # 1,896 slots: one block
    ("mirror_sphere", False),    # 2,312 slots: the BLOCK_SLOTS loop
    ("mirror_sphere", True),     # the same in float64
    ("cornell_diffuse", True),
])
def test_traverse_dense_matches_jax(scenes, rays, name, f64):
    js, ps = scenes if name == "rects350" else _dense_scene(name)
    S = ps.wbvh_tri9f.shape[0] * pwide.LEAF_SIZE
    assert (S > ptd.BLOCK_SLOTS) == (name == "mirror_sphere")
    ro, rd = rays
    if name != "rects350":  # rays from inside the box
        ro = ro * 0.3
    act = np.arange(ro.shape[0]) % 5 != 0
    tm = np.where(np.arange(ro.shape[0]) % 3 == 0, 2.0, 1e30).astype(np.float32)
    out_j = jtd._traverse_dense(js.wbvh_tri9f, js.wbvh_slot_tri, jnp.asarray(ro),
                                jnp.asarray(rd), jnp.asarray(tm),
                                jnp.asarray(act), f64=f64)
    out_p = ptd.traverse_dense(ps.wbvh_tri9f, ps.wbvh_slot_tri, torch.tensor(ro),
                               torch.tensor(rd), torch.tensor(tm),
                               torch.tensor(act), f64=f64)
    h = _same_hits(out_p, out_j)
    assert not h[~act].any()
    assert (out_p[0].numpy()[h] < tm[h]).all()


def test_traverse_dense_entry_points_read_double_rt(scenes, rays):
    """closest_hit / any_hit take f64 from settings.double_rt and agree with
    the float32 run; occlusion agrees with the wide traversal."""
    import dataclasses
    _, ps = scenes
    ro, rd = (torch.tensor(x) for x in rays)
    dbl = dataclasses.replace(
        ps, settings=dataclasses.replace(ps.settings, double_rt=True))
    t32, tri32, _, _ = ptd.closest_hit(ps, ro, rd)
    t64, tri64, _, _ = ptd.closest_hit(dbl, ro, rd)
    h = torch.isfinite(t32)
    assert torch.equal(torch.isfinite(t64), h)
    assert float((tri32[h] == tri64[h]).float().mean()) > 0.999
    np.testing.assert_allclose(t64[h].numpy(), t32[h].numpy(), rtol=1e-4)
    assert torch.equal(ptd.any_hit(ps, ro, rd, 6.0), ptw.any_hit(ps, ro, rd, 6.0))
