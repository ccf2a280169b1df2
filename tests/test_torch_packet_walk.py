"""The walk of kernel B4 (hydracore_tpu_torch/csrc/traverse_packet.cu) as
its plain twin packet_traverse_plain steps it, on the CPU:

  * push_positions, the one rule by which a node's pushes land on the
    packet's stack (B4's lanes 0..7 store at these offsets at once), leaves
    the stack, for each of the 256 push masks and any stack top, exactly as
    pushing the children one by one in order 0..7 does;
  * a scalar mirror of the kernel's loop, one packet at a time in numpy
    (the popped entry carried from step to step, the next entry read at a
    leaf's pop, a node's pushes placed by push_positions, the any-hit early
    out), gives the twin's t, u, v, slot and visit counts bit for bit, in
    both hit modes, on rays with ragged t limits and inactive lanes;
  * inactive rays change no other ray's answer and no packet's visit
    count, whatever their origin and direction hold;
  * the wrapper refuses a profile buffer for CPU tensors: the profiling
    instantiation exists only on the card.
The kernel itself is held against the twin on the card in
tests/test_torch_card.py; the twin against the JAX package's Pallas kernel
in tests/test_torch_packet.py.
"""
import numpy as np
import pytest
import torch

from hydracore_tpu_torch.bvh.wide import EMPTY_PAYLOAD
from hydracore_tpu_torch.ops import traverse_packet as tp
from hydracore_tpu_torch.ops.intersect import safe_inv
from hydracore_tpu_torch.scene.procedural import SceneBuilder

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    """tests/test_traverse_cluster.py's 350 random rects as a packet scene."""
    rng = np.random.default_rng(7)
    b = SceneBuilder()
    m = b.lambert([0.7, 0.7, 0.7])
    for _ in range(350):
        b.add_rect(rng.uniform(-4, 4, 3), rng.uniform(-0.4, 0.4, 3),
                   rng.uniform(-0.4, 0.4, 3), m)
    return b.build(cam_pos=[0, 0, 10], cam_lookat=[0, 0, 0], width=8,
                   height=8, traversal="packet")


def _packets(n_packets: int, seed: int = 3):
    """Random rays in packets: every third with a short t limit, every
    seventh inactive."""
    rng = np.random.default_rng(seed)
    R = n_packets * tp.PKT
    ro = torch.tensor(rng.uniform(-6, 6, (R, 3)), dtype=torch.float32)
    rd = torch.tensor(rng.normal(size=(R, 3)), dtype=torch.float32)
    rd = rd / rd.norm(dim=1, keepdim=True)
    t_max = torch.where(torch.arange(R) % 3 == 0, 4.0, 1e30)
    act = torch.tensor(np.arange(R) % 7 != 0)
    return tp._to_packets(ro, rd, t_max, act)[0]


@pytest.mark.parametrize("top", [0, 1, 37])
def test_push_positions_equal_sequential_pushes(top):
    masks = torch.arange(256)
    offs, n = tp.push_positions(masks)
    assert offs.shape == (256, 8) and n.shape == (256,)
    pay = torch.arange(100, 108)
    for mask in range(256):
        # the parent kernel's loop: child c pushed at the running top
        seq = [-1] * (top + 8)
        sp = top
        for c in range(8):
            if mask >> c & 1:
                seq[sp] = int(pay[c])
                sp += 1
        par = [-1] * (top + 8)
        for c in range(8):
            if mask >> c & 1:
                par[top + int(offs[mask, c])] = int(pay[c])
        assert par == seq and top + int(n[mask]) == sp, mask


def _mirror(packet: np.ndarray, nodes: np.ndarray, tris: np.ndarray,
            any_hit: bool):
    """B4's loop for one packet of 32 rays, written out in numpy float32
    with the kernel's operations in the kernel's order."""
    nodes_i = nodes.view(np.int32)
    o, d = packet[:, 0:3], packet[:, 3:6]
    t_lim, act = packet[:, 6], packet[:, 7] > 0
    inv = safe_inv(torch.tensor(d)).numpy()
    big = np.float32(tp.BIG)
    t_act = np.where(act, t_lim, -big).astype(np.float32)
    t_best = np.minimum(t_lim, big)
    u_best = np.zeros(tp.PKT, np.float32)
    v_best = np.zeros(tp.PKT, np.float32)
    slot = np.full(tp.PKT, -1, np.int32)
    stack, ent, it, more = [], 0, 0, True
    while more and it < tp.MAX_VISITS:
        it += 1
        t_cap = np.minimum(t_best, t_act)
        if ent >= 0:
            rec = nodes[ent].reshape(8, 16)
            pay = nodes_i[ent].reshape(8, 16)[:, 6]
            mask = 0
            for c in range(8):
                if pay[c] == EMPTY_PAYLOAD:
                    continue
                t0 = (rec[c, 0:3] - o) * inv
                t1 = (rec[c, 3:6] - o) * inv
                lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)
                tn = np.maximum(np.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
                tf = np.minimum(np.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
                if ((tf >= np.maximum(tn, 0)) & (tn < t_cap)).any():
                    mask |= 1 << c
            offs, n = tp.push_positions(torch.tensor(mask))
            stack += [None] * int(n)
            for c in range(8):
                if mask >> c & 1:
                    stack[-int(n) + int(offs[c])] = int(pay[c])
            del stack[tp.STACK_D - 9:]
            more = len(stack) > 0
            if more:
                ent = stack.pop()
        else:
            blk = -ent - 1
            more = len(stack) > 0
            nxt = stack.pop() if more else 0
            tri = tris[blk].reshape(8, 16)
            dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
            for k in range(8):
                v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri[k, 0:9]
                px = dy * e2z - dz * e2y
                py = dz * e2x - dx * e2z
                pz = dx * e2y - dy * e2x
                det = e1x * px + e1y * py + e1z * pz
                with np.errstate(divide="ignore"):
                    inv_det = np.where(np.abs(det) > np.float32(1e-12),
                                       np.float32(1) / det,
                                       np.float32(0)).astype(np.float32)
                sx, sy, sz = o[:, 0] - v0x, o[:, 1] - v0y, o[:, 2] - v0z
                u = (sx * px + sy * py + sz * pz) * inv_det
                qx = sy * e1z - sz * e1y
                qy = sz * e1x - sx * e1z
                qz = sx * e1y - sy * e1x
                v = (dx * qx + dy * qy + dz * qz) * inv_det
                t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
                hit = (inv_det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) \
                    & (t > np.float32(1e-5)) & (t < t_cap)
                t_best = np.where(hit, t, t_best)
                slot = np.where(hit, blk * 8 + k, slot)
                u_best = np.where(hit, u, u_best)
                v_best = np.where(hit, v, v_best)
                t_cap = np.minimum(t_cap, t_best)
            if any_hit and not (act & (slot < 0)).any():
                more = False
            ent = nxt
    return (np.where(slot >= 0, t_best, big), u_best, v_best, slot, it)


@pytest.mark.parametrize("any_hit", [False, True])
def test_twin_equals_the_kernels_loop(scene, any_hit):
    packets = _packets(12)
    nodes, tris = scene.pkt_nodes.numpy(), scene.pkt_tris.numpy()
    t, u, v, slot, visits = tp.packet_traverse(
        packets, scene.pkt_nodes, scene.pkt_tris, any_hit_mode=any_hit)
    assert int((slot >= 0).sum()) > 20
    for g in range(packets.shape[0]):
        tm, um, vm, sm, itm = _mirror(packets[g].numpy(), nodes, tris, any_hit)
        assert int(visits[g]) == itm, g
        assert np.array_equal(slot[g].numpy(), sm), g
        assert np.array_equal(t[g].numpy(), tm), g
        assert np.array_equal(u[g].numpy(), um), g
        assert np.array_equal(v[g].numpy(), vm), g


@pytest.mark.parametrize("any_hit", [False, True])
def test_inactive_rays_change_no_other_ray(scene, any_hit):
    packets = _packets(8, seed=5)
    act = packets[:, :, 7] > 0
    noisy = packets.clone()
    rng = np.random.default_rng(9)
    junk = torch.tensor(rng.normal(0, 3, (int((~act).sum()), 7)),
                        dtype=torch.float32)
    noisy[..., 0:7][~act] = junk
    a = tp.packet_traverse(packets, scene.pkt_nodes, scene.pkt_tris, any_hit)
    b = tp.packet_traverse(noisy, scene.pkt_nodes, scene.pkt_tris, any_hit)
    assert torch.equal(a[4], b[4])
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x[act], y[act])
    assert not (b[3][~act] >= 0).any()


def test_profile_needs_the_card(scene):
    packets = _packets(1)
    prof = torch.zeros((1, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        tp.packet_traverse(packets, scene.pkt_nodes, scene.pkt_tris,
                           profile=prof)
