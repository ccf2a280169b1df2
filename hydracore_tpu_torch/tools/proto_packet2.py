"""Kernel lab T4: the 1024-ray packet walk, on the card.

Port of tools/proto_packet2.py, the design that became the JAX package's
packet kernel (B4): a packet of PKT = 1024 rays (8 x 128 on the TPU) walks
the 8-wide BVH with one shared stack (STACK_D 256, the stack pointer
clamped at STACK_D - 1 after each push, MAX_VISITS 16384), node and
triangle fields read as scalars and broadcast over the packet. It is the
second instance of proto_packet.py's (T3's) kernel template in
csrc/lab_packet.cu; packet_walk_plain there is the plain version of both.

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
                                                    pack_nodes,
                                                    packet_walk_plain,
                                                    run_main)
from hydracore_tpu_torch.utils.build import launch
from hydracore_tpu_torch.utils.lab import check_tensor

TOOL = 4
P = PKT = 1024     # rays per packet
STACK_D = 256
MAX_VISITS = 16384
CLAMP = True       # sp = min(sp + push, STACK_D - 1)
SUM_UV = False     # u, v of the winning triangle
N_CHECK = 4096
LANES = 128

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


def packet_traverse(rays7, nodes, tris):
    """rays7 (7, R / 128, 128) f32 [ox oy oz dx dy dz tmax], R a multiple of
    1024, nodes (Np, 128), tris (Bp, 128) f32 -> (out (4, R / 128, 128) f32
    = [t, u, v, visits], outi (1, R / 128, 128) i32 = slot): the tool's
    packet_traverse. A CUDA tensor launches the kernel, a CPU tensor runs
    packet_traverse_plain."""
    _check(rays7, nodes, tris)
    if not rays7.is_cuda:
        return packet_traverse_plain(rays7, nodes, tris)
    rows = rays7.shape[1]
    out = torch.empty((4, rows, LANES), dtype=torch.float32, device=rays7.device)
    outi = torch.empty((1, rows, LANES), dtype=torch.int32, device=rays7.device)
    launch(_kernel_lib(), "hydra_lab_packet_walk", "T4 packet walk",
           rays7.device, P, STACK_D, MAX_VISITS, int(CLAMP),
           rays7.data_ptr(), rows * LANES,
           nodes.data_ptr(), tris.data_ptr(), out.data_ptr(), outi.data_ptr())
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


def main(variant: str = "all", device="cuda", r: int = N_RAYS, n: int = 10,
         scene=None) -> dict:
    """T4 on the tool's ray sets: see proto_packet.run_main."""
    return run_main(sys.modules[__name__], variant, device, r, n, scene)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
