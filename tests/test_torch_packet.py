"""Packet traversal of the port (kernel B4's plain twin, through the port's
closest_hit / any_hit) against the JAX package's Pallas kernel in interpret
mode, on the scene and the 2 x 1024 rays of tests/test_traverse_packet.py.

The JAX packet holds 1024 rays, the port's 32 (one warp): a ray's answer
does not depend on the packet it rides in, except among triangles at
exactly equal t. Tolerances are those of tests/test_traverse_packet.py:
  * closest hit vs the Pallas kernel: equal hit masks, the same triangle on
    > 99.9% of rays, t within rtol 1e-4 / atol 1e-5, u and v within rtol
    1e-3 / atol 1e-4;
  * any hit: occluded wherever the closest hit lies inside t_max, never
    where there is no hit at all, and equal to the Pallas kernel's answer;
  * inactive rays never hit and change no other ray's answer (rtol 1e-5);
  * a t_max caps every reported t.
The same twin is held against the port's own traverse_wide, and its visit
counts and stack bounds are checked. The kernel itself runs on the card
from tests/test_torch_card.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore_tpu.ops import traverse_packet as jtp
from hydracore_tpu.scene.procedural import SceneBuilder as JaxBuilder
from hydracore_tpu_torch.ops import traverse_packet as ptp
from hydracore_tpu_torch.ops import traverse_wide as ptw
from tests.test_torch_scene import build_with, rects_recipe, to_port

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    js = build_with(JaxBuilder, rects_recipe)
    return js, to_port(js, traversal="packet")


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(3)
    R = jtp.PKT * 2
    ro = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def test_packet_closest_matches_pallas_kernel(scenes, rays, monkeypatch):
    monkeypatch.setattr(jtp, "INTERPRET", True)
    js, ps = scenes
    ro, rd = rays
    t_j, tri_j, u_j, v_j = (np.asarray(x) for x in jtp.closest_hit(
        js, jnp.asarray(ro), jnp.asarray(rd)))
    t_p, tri_p, u_p, v_p = (x.numpy() for x in ptp.closest_hit(
        ps, torch.tensor(ro), torch.tensor(rd)))
    h = np.isfinite(t_j)
    assert np.array_equal(np.isfinite(t_p), h) and 100 < h.sum() < h.size
    assert (tri_p == tri_j).mean() > 0.999
    assert np.allclose(t_p[h], t_j[h], rtol=1e-4, atol=1e-5)
    assert np.allclose(u_p[h], u_j[h], rtol=1e-3, atol=1e-4)
    assert np.allclose(v_p[h], v_j[h], rtol=1e-3, atol=1e-4)
    # against the port's own ray-by-ray walk of the same tree
    t_w, tri_w, u_w, _ = (x.numpy() for x in ptw.closest_hit(
        ps, torch.tensor(ro), torch.tensor(rd)))
    assert (tri_p == tri_w).mean() > 0.999
    assert np.allclose(t_p[h], t_w[h], rtol=1e-4, atol=1e-5)
    assert np.allclose(u_p[h], u_w[h], rtol=1e-3, atol=1e-4)


def test_packet_any_hit_and_active_mask(scenes, rays, monkeypatch):
    monkeypatch.setattr(jtp, "INTERPRET", True)
    js, ps = scenes
    ro, rd = (torch.tensor(x) for x in rays)
    R = ro.shape[0]
    t_w = ptw.closest_hit(ps, ro, rd)[0].numpy()
    occ = ptp.any_hit(ps, ro, rd, torch.full((R,), 6.0)).numpy()
    # any-hit may find ANY triangle within t_max: where the closest is in
    # range occlusion must be reported, where no hit exists it must not be
    assert occ[t_w < 6.0].all()
    assert not occ[~np.isfinite(t_w)].any()
    occ_j = np.asarray(jtp.any_hit(js, jnp.asarray(rays[0]), jnp.asarray(rays[1]),
                                   jnp.full((R,), 6.0)))
    assert np.array_equal(occ, occ_j)

    # inactive rays never report hits and never contaminate others
    act = torch.arange(R) < R // 2
    t_a, tri_a, _, _ = ptp.closest_hit(ps, ro, rd, active=act)
    t_a = t_a.numpy()
    assert not np.isfinite(t_a[R // 2:]).any()
    assert (tri_a[R // 2:] == -1).all()
    t_full = ptp.closest_hit(ps, ro, rd)[0].numpy()
    both = np.isfinite(t_a[: R // 2])
    assert both.sum() > 50
    assert np.allclose(t_a[: R // 2][both], t_full[: R // 2][both], rtol=1e-5)
    # a packet of inactive rays around one live ray: the same answer
    lone = torch.zeros(R, dtype=torch.bool)
    lone[5::ptp.PKT] = True
    t_l = ptp.closest_hit(ps, ro, rd, active=lone)[0].numpy()
    assert np.array_equal(t_l[5::ptp.PKT], t_full[5::ptp.PKT])
    assert not np.isfinite(t_l[~lone.numpy()]).any()


def test_packet_tmax_respected(scenes, rays, monkeypatch):
    monkeypatch.setattr(jtp, "INTERPRET", True)
    js, ps = scenes
    ro, rd = (torch.tensor(x) for x in rays)
    t_w = ptw.closest_hit(ps, ro, rd)[0].numpy()
    cap = 4.0
    t_c = ptp.closest_hit(ps, ro, rd, t_max=cap)[0].numpy()
    fin = np.isfinite(t_c)
    assert (t_c[fin] < cap + 1e-4).all()
    assert fin[t_w < cap * 0.999].all()
    t_j = np.asarray(jtp.closest_hit(js, jnp.asarray(rays[0]),
                                     jnp.asarray(rays[1]), t_max=cap)[0])
    assert np.array_equal(np.isfinite(t_j), fin)
    assert np.allclose(t_c[fin], t_j[fin], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("any_hit_mode", [False, True])
def test_packet_twin_contract(scenes, rays, any_hit_mode):
    """The wrapper's raw outputs: 3e38 on a miss, slot = block * 8 + k, one
    visit count per packet below the safety bound, a ragged ray count
    padded with inactive rays, and the CPU route counts no launch."""
    _, ps = scenes
    ro, rd = (torch.tensor(x[:1000]) for x in rays)
    packets, R = ptp._to_packets(ro, rd, 6.0 if any_hit_mode else 1e30, None)
    assert R == 1000 and tuple(packets.shape) == (32, ptp.PKT, 8)
    assert not packets.reshape(-1, 8)[R:, 7].any()
    before = (ptp.closest_launches, ptp.any_launches)
    t, u, v, slot, visits = ptp.packet_traverse(
        packets, ps.pkt_nodes, ps.pkt_tris, any_hit_mode=any_hit_mode)
    assert (ptp.closest_launches, ptp.any_launches) == before
    assert slot.dtype == torch.int32 and visits.dtype == torch.int32
    assert tuple(visits.shape) == (32,)
    assert int(visits.min()) >= 1 and int(visits.max()) < ptp.MAX_VISITS
    miss = slot < 0
    assert 0 < int(miss.sum()) < slot.numel()
    assert (t[miss] == ptp.BIG).all() and (u[miss] == 0).all()
    assert int(slot.max()) < ps.wbvh_slot_tri.shape[0]
    assert (ps.wbvh_slot_tri[slot[~miss].long()] >= 0).all()
    assert (slot.reshape(-1)[R:] == -1).all()
    if not any_hit_mode:
        # a packet whose rays are all occluded stops early in any-hit mode:
        # it never pops more than the closest-hit walk of the same rays
        sure = torch.nonzero(~miss.reshape(-1)[:R]).flatten()
        sure = sure[:sure.numel() // ptp.PKT * ptp.PKT]
        assert sure.numel() >= 4 * ptp.PKT
        packets, _ = ptp._to_packets(ro[sure], rd[sure], 1e30, None)
        v_close = ptp.packet_traverse(packets, ps.pkt_nodes, ps.pkt_tris)[4]
        _, _, _, s_any, v_any = ptp.packet_traverse(
            packets, ps.pkt_nodes, ps.pkt_tris, any_hit_mode=True)
        assert (s_any >= 0).all()
        assert (v_any <= v_close).all() and int(v_any.sum()) < int(v_close.sum())


def test_packet_wrapper_refuses_bad_inputs(scenes):
    _, ps = scenes
    good = torch.zeros((2, ptp.PKT, 8))
    with pytest.raises(ValueError, match="rays must be"):
        ptp.packet_traverse(torch.zeros((2, 64, 8)), ps.pkt_nodes, ps.pkt_tris)
    with pytest.raises(ValueError, match="nodes must be"):
        ptp.packet_traverse(good, ps.wbvh_nodes, ps.pkt_tris)
    with pytest.raises(TypeError, match="float32"):
        ptp.packet_traverse(good.double(), ps.pkt_nodes, ps.pkt_tris)
