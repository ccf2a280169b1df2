"""Kernel lab T4: the 1024-ray packet walk, on the card.

Port of tools/proto_packet2.py, the design that became the JAX package's
packet kernel (B4): a packet of PKT = 1024 rays (8 x 128 on the TPU) walks
the 8-wide BVH with one shared stack (STACK_D 256, the stack pointer
clamped at STACK_D - 1 after each push, MAX_VISITS 16384), node and
triangle fields read as scalars and broadcast over the packet. Its kernel,
t4_walk_kernel in csrc/lab_packet.cu beside T3's, holds the design (512
threads x 2 rays a packet, one barrier a node entry, a stack per warp,
float4 rows, warp-uniform early exits); packet_walk_plain in proto_packet.py
is the plain version of both.
adversarial_inputs() holds the cases the tool's ray sets do not reach.

packet_traverse() launches the kernel on a CUDA tensor and runs
packet_traverse_plain on a CPU tensor; it counts launches in `launches`.
The tool took the payloads from a second, int32 view of the node pool;
the port reads the int32 bits of the one node array. pack_scene pads the
pools to a multiple of 8 rows as the tool's does, and raises for a tree
whose walk could hold more than STACK_D entries, so the clamp, which stays
because it is the tool's function, is never met silently. main() walks
bench_scene(512, 512) in place of the reference's test_224, as T3's does.

    python -m hydracore_tpu_torch.tools.proto_packet2 [coherent|incoherent|all]

prints the tool's lines as proto_packet does, with "t match / tri match"
on the first 4,096 rays.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from hydracore_tpu_torch.tools.proto_packet import (N_RAYS, _kernel_lib,
                                                    max_visits_case, node_row,
                                                    pack_nodes,
                                                    packet_walk_plain,
                                                    run_main, tri_row)
from hydracore_tpu_torch.utils.build import CI, VP, launch
from hydracore_tpu_torch.utils.lab import check_tensor

TOOL = 4
P = PKT = 1024     # rays per packet
STACK_D = 256
MAX_VISITS = 16384
CLAMP = True       # sp = min(sp + push, STACK_D - 1)
SUM_UV = False     # u, v of the winning triangle
N_CHECK = 4096
LANES = 128
WARPS = 16         # warps a packet in the kernel (512 threads x 2 rays)
# columns of packet_traverse's profile
PROFILE = ("clock64 start", "clock64 end", "SM", "node entries",
           "leaf entries", "slab tests (a warp, a child, a ray a thread)",
           "triangles past the early exit (a warp)")

launches = 0


def reset_launch_counts() -> None:
    global launches
    launches = 0


def pack_scene(sc):
    """The tool's pack_scene: (nodes (Np, 128), tris (Bp, 128)), padded to a
    multiple of 8 rows; the payloads are nodes.view(torch.int32)."""
    return pack_nodes(sc, STACK_D, pad=True)


def _check(rays7, nodes, tris):
    check_tensor("rays7", rays7, torch.float32, (7, None, LANES))
    if rays7.shape[1] % (P // LANES):
        raise ValueError(f"{rays7.shape[1] * LANES} rays: not a multiple of {P}")
    check_tensor("nodes", nodes, torch.float32, (None, 128), rays7.device)
    check_tensor("tris", tris, torch.float32, (None, 128), rays7.device)


def packet_traverse_plain(rays7, nodes, tris):
    """The tool's (out, outi) from packet_walk_plain."""
    r = rays7.reshape(7, -1)
    t, slot, u, v, vis = packet_walk_plain(
        r[0:3].T, r[3:6].T, r[6], nodes, tris, P, STACK_D, MAX_VISITS, CLAMP,
        SUM_UV)
    rows = rays7.shape[1]
    visits = vis.to(torch.float32).repeat_interleave(P)
    out = torch.stack([t, u, v, visits]).reshape(4, rows, LANES)
    return out, slot.reshape(1, rows, LANES)


def _t4_lib():
    """csrc/lab_packet.cu's library with hydra_lab_t4_profile's arguments
    set."""
    lib = _kernel_lib()
    lib.hydra_lab_t4_profile.argtypes = [VP, CI, VP, VP, VP, VP, VP, VP]
    lib.hydra_lab_t4_profile.restype = CI
    return lib


def packet_traverse(rays7, nodes, tris, profile=None):
    """rays7 (7, R / 128, 128) f32 [ox oy oz dx dy dz tmax], R a multiple of
    1024, nodes (Np, 128), tris (Bp, 128) f32 -> (out (4, R / 128, 128) f32
    = [t, u, v, visits], outi (1, R / 128, 128) i32 = slot): the tool's
    packet_traverse. A CUDA tensor launches the kernel, a CPU tensor runs
    packet_traverse_plain. On the card, `profile`, a zeroed int64 tensor
    (R / 1024, 7), runs the kernel's profiling build, which fills it per
    packet (PROFILE)."""
    _check(rays7, nodes, tris)
    if not rays7.is_cuda:
        if profile is not None:
            raise ValueError("the profile is the kernel's: a CUDA tensor")
        return packet_traverse_plain(rays7, nodes, tris)
    rows = rays7.shape[1]
    out = torch.empty((4, rows, LANES), dtype=torch.float32, device=rays7.device)
    outi = torch.empty((1, rows, LANES), dtype=torch.int32, device=rays7.device)
    if profile is None:
        launch(_kernel_lib(), "hydra_lab_packet_walk", "T4 packet walk",
               rays7.device, P, STACK_D, MAX_VISITS, int(CLAMP),
               rays7.data_ptr(), rows * LANES,
               nodes.data_ptr(), tris.data_ptr(), out.data_ptr(),
               outi.data_ptr())
    else:
        check_tensor("profile", profile, torch.int64,
                     (rows * LANES // P, len(PROFILE)), rays7.device)
        launch(_t4_lib(), "hydra_lab_t4_profile", "T4 packet walk (profile)",
               rays7.device, rays7.data_ptr(), rows * LANES,
               nodes.data_ptr(), tris.data_ptr(), out.data_ptr(),
               outi.data_ptr(), profile.data_ptr())
    global launches
    launches += 1
    return out, outi


def pack_rays(ro: np.ndarray, rd: np.ndarray) -> torch.Tensor:
    """The tool's rays7 (7, R / 128, 128): [ox oy oz dx dy dz tmax], tmax
    1e30."""
    R = ro.shape[0]
    r7 = np.zeros((7, R // LANES, LANES), np.float32)
    r7[0:3] = ro.T.reshape(3, R // LANES, LANES)
    r7[3:6] = rd.T.reshape(3, R // LANES, LANES)
    r7[6] = 1e30
    return torch.tensor(r7)


def unpack(res):
    """(t, slot, u, v) (R,) and visits per packet of the tool's output."""
    out, outi = res
    return (out[0].reshape(-1), outi[0].reshape(-1), out[1].reshape(-1),
            out[2].reshape(-1), out[3].reshape(-1, P)[:, 0])


def ray_range(rays7, start: int, n: int):
    """Rays [start, start + n) of rays7 (multiples of 128)."""
    return rays7[:, start // LANES:(start + n) // LANES].contiguous()


# the cases adversarial_inputs() holds, in order
ADVERSARIAL = ("edges", "max_visits", "clamp")


def _rays7(ro, rd, tmax) -> torch.Tensor:
    r7 = np.concatenate([np.asarray(ro, np.float32).T,
                         np.asarray(rd, np.float32).T,
                         np.asarray(tmax, np.float32)[None]])
    return torch.tensor(np.ascontiguousarray(r7).reshape(7, -1, LANES))


def _edges():
    """Two packets over a hand-made tree: the root holds leaves A and B on
    the same box [0, 1]^3, a node over leaves C, D (sharing the face x =
    2.5), leaf E (sharing A's face x = 0) and a flat leaf F (z = 2). A and B
    hold the same triangle (equal t across leaves), B holds it twice (equal
    t in a leaf); C, D hold the same triangle on their shared face and A, E
    one on theirs. Packet 0: rays down from z = 3 with d.x, d.y in {+0.0,
    -0.0, +1e-13, -1e-13} from origins on the boxes' faces and edges; rays
    from inside the boxes; rays lying in the faces x = 0, x = 2.5 and z = 2;
    rays along +x through the shared faces, a quarter with t_max at the
    distance of a triangle (strict <: no hit there). Packet 1: no ray enters
    the root's children."""
    unit = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    t1 = ((0, 0, 0.5), (1, 0, 0.5), (0, 1, 0.5))
    face0 = ((0, 0, 0), (0, 1, 0), (0, 0, 1))
    face25 = ((2.5, 0, 0), (2.5, 1, 0), (2.5, 0, 1))
    tris = np.stack([
        tri_row([t1, t1, ((1, 1, 0.5), (0, 1, 0.5), (1, 0, 0.5)), face0]),  # A
        tri_row([t1, t1, ((0, 0, 0.25), (1, 0, 0.25), (1, 1, 0.25))]),     # B
        tri_row([((2.25, 0, 0), (2.25, 1, 0), (2.25, 0, 1)), face25]),      # C
        tri_row([face25, ((2.75, 0, 0), (2.75, 1, 1), (2.75, 0, 1))]),      # D
        tri_row([((-0.5, 0, 0), (-0.5, 1, 0), (-0.5, 0, 1)), face0]),       # E
        tri_row([((0, 0, 2), (1, 0, 2), (0, 1, 2))]),                       # F
    ])
    nodes = np.stack([
        node_row([(*unit, -1), (*unit, -2),
                   ((2.0, 0.0, 0.0), (3.0, 1.0, 1.0), 1), None,
                   ((-1.0, 0.0, 0.0), (0.0, 1.0, 1.0), -5),
                   ((0.0, 0.0, 2.0), (1.0, 1.0, 2.0), -6)]),
        node_row([((2.0, 0.0, 0.0), (2.5, 1.0, 1.0), -3),
                   ((2.5, 0.0, 0.0), (3.0, 1.0, 1.0), -4)]),
    ])
    rng = np.random.default_rng(17)
    eps = np.array([0.0, -0.0, 1e-13, -1e-13], np.float32)
    grid = np.array([-0.5, -0.0, 0.0, 1e-13, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0,
                     2.25, 2.5, 2.75, 3.0, 3.25, 1.0 - 2.0 ** -24], np.float32)
    gx, gy = np.meshgrid(grid, grid, indexing="ij")
    down_o = np.stack([gx.ravel(), gy.ravel(), np.full(256, 3.0)], 1)
    k = np.arange(256)
    down_d = np.stack([eps[k % 4], eps[(k // 4) % 4], -np.ones(256)], 1)
    lo = np.array([[0, 0, 0], [2, 0, 0], [2.5, 0, 0], [-1, 0, 0]], np.float32)
    inside_o = lo[k % 4] + rng.uniform(0.05, 0.45, (256, 3)) * [1, 2, 2]
    inside_d = rng.normal(size=(256, 3))
    plane = np.array([0.0, 2.5, -0.0, 2.0], np.float32)[k % 4]
    face_o = np.where((k % 4 == 3)[:, None],
                      np.stack([rng.uniform(0, 1, 256), rng.uniform(0, 1, 256),
                                plane], 1),
                      np.stack([plane, rng.uniform(0, 1, 256),
                                rng.uniform(0, 1, 256)], 1))
    face_d = rng.normal(size=(256, 3))
    face_d[k % 4 < 3, 0] = eps[k[k % 4 < 3] // 4 % 4]
    face_d[k % 4 == 3, 2] = eps[k[k % 4 == 3] // 4 % 4]
    along_o = np.stack([np.full(256, -3.0), rng.uniform(0, 1, 256),
                        rng.uniform(0, 1, 256)], 1)
    along_d = np.stack([np.ones(256), eps[k % 4], eps[(k // 4) % 4]], 1)
    along_t = np.where(k % 4 == 0, 2.5, 1e30)  # x = -0.5 at exactly t = 2.5
    far_o = 10.0 + rng.uniform(0, 1, (1024, 3))
    far_d = np.abs(rng.normal(size=(1024, 3))) + 0.1
    ro = np.concatenate([down_o, inside_o, face_o, along_o, far_o])
    rd = np.concatenate([down_d, inside_d, face_d, along_d, far_d])
    tmax = np.concatenate([np.full(768, 1e30), along_t, np.full(1024, 1e30)])
    return _rays7(ro, rd, tmax), torch.tensor(nodes), torch.tensor(tris)


def _max_visits():
    """proto_packet.max_visits_case for one T4 packet."""
    ro, rd, nodes, tris = max_visits_case(P)
    return (_rays7(ro, rd, np.full(P, 1e30)), torch.tensor(nodes),
            torch.tensor(tris))


def _clamp(levels: int = 48):
    """One packet over a chain of `levels` node rows that drives the stack
    past STACK_D - 1: every child box is [-1, 1]^3, which holds every ray's
    origin, so each node pushes every child it has (child order c = 0..7);
    child 7 is the next row and pops first, the others are leaves of one
    triangle each (z planes in a shuffled order), so each row leaves 6 or 7
    entries below it and the stack reaches the clamp at about row 37. Odd
    rows put child 3 on a tiny box far off that no ray hits (a gap in the
    mask), rows 2 mod 4 leave child 5 empty; the last row holds 8 leaves. At
    the clamp the tool drops the pushes past STACK_D - 1 (the word there is
    overwritten, never read) and pops the word below, a leaf of the same
    row, not the next row; the walk then pops the leaves left on the stack
    and ends well before MAX_VISITS."""
    box = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    far = ((100.0, 100.0, 100.0), (100.001, 100.001, 100.001))
    rows, n_leaf = [], 0
    for d in range(levels):
        children = []
        for c in range(8):
            if c == 5 and d % 4 == 2:
                children.append(None)
            elif c == 7 and d + 1 < levels:
                children.append((*box, d + 1))
            else:
                n_leaf += 1
                children.append((*(far if c == 3 and d % 2 else box), -n_leaf))
        rows.append(node_row(children))
    order = np.random.default_rng(29).permutation(n_leaf)
    z = -0.95 + 1.9 * (order + 0.5) / n_leaf
    tris = np.stack([tri_row([((-4, -4, zk), (8, -4, zk), (-4, 8, zk))])
                     for zk in z])
    rng = np.random.default_rng(31)
    ro = rng.uniform(-0.9, 0.9, (P, 3))
    rd = rng.normal(size=(P, 3))
    return (_rays7(ro, rd, np.full(P, 1e30)), torch.tensor(np.stack(rows)),
            torch.tensor(tris))


def adversarial_inputs(device="cpu") -> dict:
    """name -> (rays7, nodes, tris) on `device`, the cases the tool's ray
    sets do not reach: "edges" (_edges: signed zeros and +-1e-13 in d, rays
    on and in box faces, from inside boxes, equal t in a leaf and across
    leaves, a t_max at a hit's t, a packet that enters no child of the
    root), "max_visits" (_max_visits: a packet cut at MAX_VISITS) and
    "clamp" (_clamp: a stack driven past STACK_D - 1)."""
    cases = {"edges": _edges(), "max_visits": _max_visits(), "clamp": _clamp()}
    return {k: tuple(x.to(device) for x in cases[k]) for k in ADVERSARIAL}


def main(variant: str = "all", device="cuda", r: int = N_RAYS, n: int = 10,
         scene=None) -> dict:
    """T4 on the tool's ray sets: see proto_packet.run_main."""
    return run_main(sys.modules[__name__], variant, device, r, n, scene)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
