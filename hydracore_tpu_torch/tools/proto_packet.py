"""Kernel lab T3: the 128-ray packet walk with a shared stack, on the card.

Port of tools/proto_packet.py, which measured a packet of P = 128 rays
walking the 8-wide BVH with one shared stack (STACK_D 192, MAX_VISITS
4096, no clamp of the stack pointer): a popped node pushes the children
that some ray of the packet hits, a popped leaf tests its 8 triangles
against every ray. csrc/lab_packet.cu holds the function and the design,
with T4's 1024-ray walk (proto_packet2.py) beside it.

packet_traverse() launches the kernel on a CUDA tensor and runs
packet_traverse_plain on a CPU tensor; it counts launches in `launches`.
The plain version of both walks is packet_walk_plain(), parameterized by
the tools' sizes: every packet steps together with its own stack row. A
ray's t depends only on the tree; its visit count and, among equal t, its
triangle on the packet it rides in, so the walks keep the tools' packets:
rays [i * P, (i + 1) * P) of the flattened order. adversarial_inputs()
holds the cases the tool's ray sets do not reach.

The tool's pltpu.bitcast of a 0-d payload does not trace (interpret mode
raises "Not implemented: bitcast 1D"); the function meant is the payload's
int32 bits, which is what the port reads. The tool loaded the reference's
test_224 scene, which is not in the repo: main() walks bench_scene(512,
512) (26,252 triangles, the teapot's ~25.6k in size) with the tool's ray
formulas, the coherent rays from bench_scene's camera (0, 0, 5.6) and the
incoherent origins in its box [-2, 2]^3.

    python -m hydracore_tpu_torch.tools.proto_packet [coherent|incoherent|all]

prints, as the tool does, ms and Mrays/s for 262,144 rays (on the card the
mean of n calls replayed from a CUDA graph), the visits per packet (mean
and most, and how many packets reached MAX_VISITS), and "t match / tri
match" against ops/traverse_wide.closest_hit on the first 2,048 rays, each
line beside the card's name and power limit.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from hydracore_tpu_torch.bvh.wide import EMPTY_PAYLOAD
from hydracore_tpu_torch.ops import traverse_wide as tw
from hydracore_tpu_torch.ops.intersect import safe_inv
from hydracore_tpu_torch.scene.procedural import bench_scene
from hydracore_tpu_torch.utils.build import CI, VP, launch, load_lib
from hydracore_tpu_torch.utils.device import resolve_device
from hydracore_tpu_torch.utils.lab import check_tensor, device_label, time_ms

TOOL = 3
P = 128           # rays per packet
STACK_D = 192     # shared stack depth
MAX_VISITS = 4096
CLAMP = False     # no clamp of the stack pointer
SUM_UV = True     # u, v as the sum over k of winf[k] * u[k]
N_CHECK = 2048    # rays held against traverse_wide in main()
RPT = 1           # rays a thread in the kernel (128 threads a packet)
WARPS = P // RPT // 32  # warps a packet in the kernel
# columns of packet_traverse's profile
PROFILE = ("clock64 start", "clock64 end", "SM", "node entries",
           "leaf entries", "children tested (a warp, a ray a thread)",
           "triangles past the first pass (a warp)",
           "triangles tested, not flat (a warp)")
N_RAYS = 262144
W = 512
# the coherent rays' eye: bench_scene's camera, for the tool's (0, 10, 25)
EYE = (0.0, 0.0, 5.6)
# the incoherent origins' box: bench_scene's, for the tool's [-10, 10] x
# [0, 20] x [-10, 10]
BOX = 2.0

launches = 0

_lib = None


def reset_launch_counts() -> None:
    global launches
    launches = 0


def _kernel_lib():
    """csrc/lab_packet.cu's library, built at first use."""
    global _lib
    if _lib is None:
        _lib = load_lib("lab_packet.cu", "hydra_lab_packet_walk",
                        [CI, CI, CI, CI, VP, CI, VP, VP, VP, VP, VP])
        _lib.hydra_lab_t3_profile.argtypes = [VP, CI, VP, VP, VP, VP, VP]
        _lib.hydra_lab_t3_profile.restype = CI
    return _lib


def pack_nodes(sc, stack_d: int, pad: bool):
    """(nodes (N, 128), tris (B, 128)) f32 from the scene's wbvh_nodes and
    wbvh_tri9f on their device: a node row holds 8 children x 16 floats
    [bmin.xyz bmax.xyz payload pad ...]. With `pad` the rows go up to a
    multiple of 8 (node rows with EMPTY payloads, triangle rows with far
    degenerate triangles), as T4's packer does. Raises when a depth-first
    walk of the tree could hold more than stack_d entries (7 * depth + 1)."""
    depth = int(sc.wbvh_depth)
    if 7 * depth + 1 > stack_d:
        raise ValueError(f"wide-BVH depth {depth} needs a stack of "
                         f"{7 * depth + 1} > STACK_D={stack_d}")
    nodes = torch.as_tensor(sc.wbvh_nodes)
    tsrc = torch.as_tensor(sc.wbvh_tri9f)
    N, B = nodes.shape[0], tsrc.shape[0]
    Np, Bp = ((N + 7) // 8 * 8, (B + 7) // 8 * 8) if pad else (N, B)
    n128 = torch.zeros((Np, 128), dtype=torch.float32, device=nodes.device)
    n128.view(Np, 8, 16)[:N, :, 0:8] = nodes
    n128.view(torch.int32).view(Np, 8, 16)[N:, :, 6] = EMPTY_PAYLOAD
    t128 = torch.zeros((Bp, 128), dtype=torch.float32, device=nodes.device)
    t128[:B] = tsrc
    t128.view(Bp, 8, 16)[B:, :, 0:3] = 1e30
    return n128, t128


def pack_scene(sc):
    """The tool's pack_scene: (nodes128 (N, 128), tris128 (B, 128)), not
    padded."""
    return pack_nodes(sc, STACK_D, pad=False)


def packet_walk_plain(ro, rd, t0, nodes, tris, p: int, stack_d: int,
                      max_visits: int, clamp: bool, sum_uv: bool):
    """The walk of csrc/lab_packet.cu in plain PyTorch, for rays ro, rd
    (R, 3) and t0 (R,) in packets of p: every packet steps together with its
    own stack row, so the walk order, the pruning and the ties are the
    kernel's. Returns (t, slot, u, v) (R,) and visits (R // p,) i32."""
    R = ro.shape[0]
    G = R // p
    dev = ro.device
    nodes_i = nodes.view(torch.int32)
    ox, oy, oz = (ro[:, k].reshape(G, p) for k in range(3))
    dx, dy, dz = (rd[:, k].reshape(G, p) for k in range(3))
    tmax = t0.reshape(G, p)
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    t_best = tmax.clone()
    slot_best = torch.full((G, p), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros((G, p), dtype=torch.float32, device=dev)
    v_best = torch.zeros((G, p), dtype=torch.float32, device=dev)
    stack = torch.zeros((G, stack_d), dtype=torch.int32, device=dev)
    sp = torch.ones((G,), dtype=torch.int64, device=dev)
    visits = torch.zeros((G,), dtype=torch.int32, device=dev)
    k8 = torch.arange(8, device=dev)

    while True:
        go = (sp > 0) & (visits < max_visits)
        if not clamp:
            go &= sp <= stack_d  # the kernel's guard; the packer keeps it true
        live = torch.nonzero(go).flatten()
        if live.numel() == 0:
            break
        sp[live] -= 1
        visits[live] += 1
        ent = stack[live, sp[live]]
        is_node = ent >= 0

        g = live[is_node]
        if g.numel() > 0:
            row = ent[is_node].long()
            rec = nodes[row].view(-1, 8, 16)
            pay = nodes_i[row].view(-1, 8, 16)[:, :, 6]
            t_cap = torch.minimum(t_best[g], tmax[g])[:, :, None]

            def slab(lo, hi, o, inv):
                a = (rec[:, None, :, lo] - o[g][:, :, None]) * inv[g][:, :, None]
                b = (rec[:, None, :, hi] - o[g][:, :, None]) * inv[g][:, :, None]
                return torch.minimum(a, b), torch.maximum(a, b)

            nx, fx = slab(0, 3, ox, ix)
            ny, fy = slab(1, 4, oy, iy)
            nz, fz = slab(2, 5, oz, iz)
            tn = torch.maximum(torch.maximum(nx, ny), nz)   # (K, p, 8)
            tf = torch.minimum(torch.minimum(fx, fy), fz)
            hit = (tf >= torch.clamp(tn, min=0.0)) & (tn < t_cap)
            push = hit.any(dim=1) & (pay != EMPTY_PAYLOAD)  # (K, 8)
            top = sp[g]
            for c in range(8):
                m = push[:, c]
                w = m if clamp else m & (top < stack_d)
                stack[g[w], top[w]] = pay[w, c]
                top = top + m.long()
                if clamp:
                    top = torch.clamp(top, max=stack_d - 1)
            sp[g] = top

        g = live[~is_node]
        if g.numel() > 0:
            blk = -ent[~is_node] - 1
            tri = tris[blk.long()].view(-1, 8, 16)
            o_x, o_y, o_z = (x[g][:, :, None] for x in (ox, oy, oz))
            d_x, d_y, d_z = (x[g][:, :, None] for x in (dx, dy, dz))
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
                tri[:, None, :, f] for f in range(9))
            px = d_y * e2z - d_z * e2y                      # (K, p, 8)
            py = d_z * e2x - d_x * e2z
            pz = d_x * e2y - d_y * e2x
            det = e1x * px + e1y * py + e1z * pz
            inv = torch.where(det.abs() > 1e-12,
                              1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
            sx, sy, sz = o_x - v0x, o_y - v0y, o_z - v0z
            u = (sx * px + sy * py + sz * pz) * inv
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            v = (d_x * qx + d_y * qy + d_z * qz) * inv
            t = (e2x * qx + e2y * qy + e2z * qz) * inv
            hit = (inv != 0.0) & (u >= 0) & (v >= 0) & (u + v <= 1.0) \
                & (t > 1e-5) & (t < t_best[g][:, :, None])
            # the smallest t, the first k among equal t
            t_m = torch.where(hit, t, float("inf"))
            t_k = t_m.amin(dim=2)
            k = torch.where(hit & (t_m == t_k[:, :, None]), k8, 8).amin(dim=2)
            won = k < 8
            kk = torch.clamp(k, max=7)[:, :, None]
            if sum_uv:
                winf = (k8 == k[:, :, None]).to(torch.float32)
                u_new, v_new = winf[..., 0] * u[..., 0], winf[..., 0] * v[..., 0]
                for j in range(1, 8):
                    u_new = u_new + winf[..., j] * u[..., j]
                    v_new = v_new + winf[..., j] * v[..., j]
            else:
                u_new, v_new = u.gather(2, kk)[..., 0], v.gather(2, kk)[..., 0]
            slot_best[g] = torch.where(won, blk[:, None] * 8 + k.int(),
                                       slot_best[g])
            t_best[g] = torch.where(won, t_k, t_best[g])
            u_best[g] = torch.where(won, u_new, u_best[g])
            v_best[g] = torch.where(won, v_new, v_best[g])

    return (t_best.reshape(R), slot_best.reshape(R), u_best.reshape(R),
            v_best.reshape(R), visits)


def _check(rays8, nodes, tris):
    check_tensor("rays8", rays8, torch.float32, (8, None))
    if rays8.shape[1] % P:
        raise ValueError(f"{rays8.shape[1]} rays: not a multiple of {P}")
    check_tensor("nodes128", nodes, torch.float32, (None, 128), rays8.device)
    check_tensor("tris128", tris, torch.float32, (None, 128), rays8.device)


def packet_traverse_plain(rays8, nodes128, tris128):
    """The tool's (8, R) output from packet_walk_plain."""
    rd = rays8[4:7].T
    t, slot, u, v, vis = packet_walk_plain(
        rays8[0:3].T, rd, rays8[3], nodes128, tris128, P, STACK_D,
        MAX_VISITS, CLAMP, SUM_UV)
    R = rays8.shape[1]
    out = torch.zeros((8, R), dtype=torch.float32, device=rays8.device)
    out[0], out[1], out[2], out[3] = t, slot.view(torch.float32), u, v
    out[4] = vis.to(torch.float32).repeat_interleave(P)
    return out


def packet_traverse(rays8, nodes128, tris128, profile=None):
    """rays8 (8, R) f32 [ox oy oz tmax dx dy dz pad], R a multiple of 128,
    nodes128 (N, 128), tris128 (B, 128) f32 -> (8, R) f32 = [t, slot bits,
    u, v, visits, 0, 0, 0]: the tool's packet_traverse. A CUDA tensor
    launches the kernel, a CPU tensor runs packet_traverse_plain. On the
    card, `profile`, a zeroed int64 tensor (R / 128, 8), runs the kernel's
    profiling build, which fills it per packet (PROFILE)."""
    _check(rays8, nodes128, tris128)
    if not rays8.is_cuda:
        if profile is not None:
            raise ValueError("the profile is the kernel's: a CUDA tensor")
        return packet_traverse_plain(rays8, nodes128, tris128)
    R = rays8.shape[1]
    out = torch.empty((8, R), dtype=torch.float32, device=rays8.device)
    if profile is None:
        launch(_kernel_lib(), "hydra_lab_packet_walk", "T3 packet walk",
               rays8.device, P, STACK_D, MAX_VISITS, int(CLAMP),
               rays8.data_ptr(), R, nodes128.data_ptr(),
               tris128.data_ptr(), out.data_ptr(), None)
    else:
        check_tensor("profile", profile, torch.int64, (R // P, len(PROFILE)),
                     rays8.device)
        launch(_kernel_lib(), "hydra_lab_t3_profile", "T3 packet walk (profile)",
               rays8.device, rays8.data_ptr(), R, nodes128.data_ptr(),
               tris128.data_ptr(), out.data_ptr(), profile.data_ptr())
    global launches
    launches += 1
    return out


def pack_rays(ro: np.ndarray, rd: np.ndarray) -> torch.Tensor:
    """The tool's rays8 (8, R): [ox oy oz tmax dx dy dz 0], tmax 1e30."""
    r8 = np.zeros((8, ro.shape[0]), np.float32)
    r8[0:3] = ro.T
    r8[3] = 1e30
    r8[4:7] = rd.T
    return torch.tensor(r8)


def unpack(out):
    """(t, slot, u, v) (R,) and visits per packet of the tool's output."""
    return (out[0], out[1].view(torch.int32), out[2], out[3],
            out[4].reshape(-1, P)[:, 0])


def ray_range(rays8, start: int, n: int):
    """Rays [start, start + n) of rays8."""
    return rays8[:, start:start + n].contiguous()


def tool_rays(r: int = N_RAYS) -> dict:
    """The tools' two ray sets of r <= 262,144 rays, {name: (ro, rd)} f32
    numpy: coherent rays from EYE through a 512 x 512 direction grid in the
    tools' order (px = i // 512, py = i % 512), and incoherent ones from
    default_rng(0), origins uniform in [-BOX, BOX]^3, normal directions."""
    if not 0 < r <= W * W:
        raise ValueError(f"r must be in (0, {W * W}], got {r}")
    rng = np.random.default_rng(0)
    ro_c = np.tile(np.array(EYE, np.float32), (r, 1))
    px = np.repeat(np.arange(W), W)[:r]
    py = np.tile(np.arange(W), W)[:r]
    d = np.stack([(px / W - 0.5) * 1.2, (py / W - 0.5) * 1.2,
                  -np.ones(r)], 1).astype(np.float32)
    rd_c = d / np.linalg.norm(d, axis=1, keepdims=True)
    ro_i = rng.uniform(-BOX, BOX, (r, 3)).astype(np.float32)
    rd_i = rng.normal(size=(r, 3)).astype(np.float32)
    rd_i /= np.linalg.norm(rd_i, axis=1, keepdims=True)
    return {"coherent": (ro_c, rd_c), "incoherent": (ro_i, rd_i)}


def node_row(children) -> np.ndarray:
    """One node row: children[c] = (bmin, bmax, payload) or None; the other
    slots empty (NaN box, EMPTY_PAYLOAD), as bvh/wide.py leaves them."""
    row = np.zeros((8, 16), np.float32)
    row[:, 0:6] = np.nan
    row.view(np.int32)[:, 6] = EMPTY_PAYLOAD
    for c, ch in enumerate(children):
        if ch is not None:
            row[c, 0:3], row[c, 3:6] = ch[0], ch[1]
            row.view(np.int32)[c, 6] = ch[2]
    return row.reshape(128)


def tri_row(tris) -> np.ndarray:
    """One leaf row of up to 8 triangles (v0, v1, v2) as [v0 e1 e2 pad]; the
    other slots far degenerate triangles (v0 at 1e30, no edges)."""
    row = np.zeros((8, 16), np.float32)
    row[:, 0:3] = 1e30
    for k, (v0, v1, v2) in enumerate(tris):
        v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
        row[k, 0:3], row[k, 3:6], row[k, 6:9] = v0, v1 - v0, v2 - v0
    return row.reshape(128)


def _tri_edges(tris) -> np.ndarray:
    """One leaf row of up to 8 triangles given as (v0, e1, e2) directly (an
    edge too small to survive v1 - v0 at a far v0); the other slots far
    degenerate triangles, as tri_row leaves them."""
    row = tri_row([]).reshape(8, 16)
    for k, (v0, e1, e2) in enumerate(tris):
        row[k, 0:3], row[k, 3:6], row[k, 6:9] = v0, e1, e2
    return row.reshape(128)


def _rays8(ro, rd, tmax) -> torch.Tensor:
    r8 = np.zeros((8, len(ro)), np.float32)
    r8[0:3] = np.asarray(ro, np.float32).T
    r8[3] = tmax
    r8[4:7] = np.asarray(rd, np.float32).T
    return torch.tensor(r8)


# the cases adversarial_inputs() holds, in order
ADVERSARIAL = ("edges", "max_visits", "sumuv")


def _edges():
    """T4's "edges" (proto_packet2._edges: signed zeros and +-1e-13 in d,
    rays on and in box faces and from inside boxes, equal t in a leaf and
    across leaves, a t_max at a hit's t, rays that enter no child of the
    root) in 16 packets of 128."""
    from hydracore_tpu_torch.tools import proto_packet2

    rays7, nodes, tris = proto_packet2.adversarial_inputs()["edges"]
    r = rays7.reshape(7, -1).numpy()
    return _rays8(r[0:3].T, r[3:6].T, r[6]), nodes, tris


def max_visits_case(p: int, levels: int = 5):
    """One packet of p rays over a tree of `levels` node rows in a chain,
    every row's 8 children the next row (the last row's: one leaf block),
    all on the box [-1, 1]^3 that holds every ray's origin: the walk would
    pop (8^(levels + 1) - 1) / 7 entries (37,449 for 5), so it stops at
    MAX_VISITS with entries left on the stack (at most 7 * levels + 1).
    Returns (ro, rd, nodes, tris) numpy."""
    box = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    nodes = np.stack([node_row([(*box, d + 1 if d + 1 < levels else -1)] * 8)
                      for d in range(levels)])
    tris = tri_row([((-1, -1, z), (1, -1, z), (-1, 1, z))
                    for z in np.linspace(-0.8, 0.8, 8)])[None]
    rng = np.random.default_rng(23)
    ro = rng.uniform(-0.9, 0.9, (p, 3))
    rd = rng.normal(size=(p, 3))
    return ro, rd, nodes, tris


def _max_visits():
    """max_visits_case for one T3 packet."""
    ro, rd, nodes, tris = max_visits_case(P)
    return _rays8(ro, rd, 1e30), torch.tensor(nodes), torch.tensor(tris)


def _sumuv():
    """Two packets of rays along +-z onto three leaves whose winner is the
    unit right triangle at x = 0, 10 and 20 (u = x, v = y there), the rays
    on its edges (u or v +-0: -0.0 where det < 0), inside it and off it;
    the losers beside the winner: leaf A's give u = NaN (an edge of zeros
    at a far vertex: inv 0 times an infinite dot), u = inf (|det| just
    above 1e-12) and v = -inf, so the tool's sum is NaN; leaf B's have u <
    0 and the far degenerate slots (u = -0.0, v = +0.0), so a winner's u =
    -0.0 stays -0.0 in the sum and its v = -0.0 becomes +0.0; leaf C's
    have u > 0, so a winner's u = -0.0 becomes +0.0."""
    unit = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    leaf_a = _tri_edges([
        ((0.0, 0.0, 0.0), *unit),
        ((1e30, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1e10, 0.0)),
        ((-1e30, 0.0, 0.0), (-2e-22, 0.0, 0.0), (0.0, 1e10, 0.0)),
        ((0.0, 1e30, 0.0), (-1e10, 0.0, 0.0), (0.0, 1.0, 0.0))])
    leaf_b = _tri_edges([((10.0, 0.0, 0.0), *unit),
                         ((20.0, 0.0, 5.0), *unit)])
    leaf_c = _tri_edges([((20.0, 0.0, 0.0), *unit),
                         ((15.0, 0.0, 5.0), *unit)])
    nodes = node_row([((-0.5, -0.5, -0.5), (1.5, 1.5, 0.5), -1),
                      ((9.5, -0.5, -0.5), (11.5, 1.5, 5.5), -2),
                      ((19.5, -0.5, -0.5), (21.5, 1.5, 5.5), -3)])[None]
    xy = np.array([0.0, -0.0, 0.25, 0.5, 1.0, 1e-13, 0.75, 1.5], np.float32)
    k = np.arange(P)
    ro = np.stack([xy[k % 8] + 10.0 * (k // 8 % 3), xy[k // 24 % 8],
                   np.full(P, -1.0)], 1)
    ro[k // 8 % 3 == 0, 0] = xy[k[k // 8 % 3 == 0] % 8]  # keep -0.0 at x = 0
    rd = np.stack([np.where(k % 2, 0.0, -0.0), np.where(k % 3, 0.0, -0.0),
                   np.ones(P)], 1)
    ro2, rd2 = ro.copy(), rd.copy()
    ro2[:, 2], rd2[:, 2] = 1.0, -1.0  # from above: det > 0
    rays = _rays8(np.concatenate([ro, ro2]), np.concatenate([rd, rd2]), 1e30)
    return rays, torch.tensor(nodes), torch.tensor(np.stack([leaf_a, leaf_b,
                                                            leaf_c]))


def adversarial_inputs(device="cpu") -> dict:
    """name -> (rays8, nodes, tris) on `device`, the cases the tool's ray
    sets do not reach: "edges" (_edges), "max_visits" (_max_visits: a
    packet cut at MAX_VISITS) and "sumuv" (_sumuv: the tool's u and v sums
    where a loser's term is NaN and where the zeros' signs decide)."""
    cases = {"edges": _edges(), "max_visits": _max_visits(), "sumuv": _sumuv()}
    return {k: tuple(x.to(device) for x in cases[k]) for k in ADVERSARIAL}


def run_main(tool, variant: str, device, r: int, n: int, scene) -> dict:
    """main() of T3 (tool = this module) or T4 (proto_packet2): each chosen
    ray set through tool.packet_traverse on `scene` (bench_scene(512, 512)
    when None), timed over n calls, its visits per packet and its hits
    against traverse_wide.closest_hit on the first tool.N_CHECK rays.
    Returns {name: {"ms", "mrays_s", "visits_mean", "visits_max",
    "at_max_visits", "t_match", "tri_match", "out"}}, "out" the first call's
    (t, slot, u, v) (r,) and visits per packet."""
    dev = resolve_device(device)
    names = ["coherent", "incoherent"] if variant == "all" else [variant]
    if not set(names) <= {"coherent", "incoherent"}:
        raise ValueError("variant must be coherent, incoherent or all")
    sc = (bench_scene(W, W) if scene is None else scene).to(dev)
    nodes, tris = tool.pack_scene(sc)
    label = device_label(dev)
    print(f"T{tool.TOOL}: nodes {tuple(nodes.shape)} {nodes.numel() * 4 / 1e6:.1f}MB"
          f"  tris {tuple(tris.shape)} {tris.numel() * 4 / 1e6:.1f}MB, packets "
          f"of {tool.P} [{label}]", flush=True)
    rays = tool_rays(r)
    slot_tri = sc.wbvh_slot_tri.long()
    res = {}
    for name in names:
        ro, rd = rays[name]
        packed = tool.pack_rays(ro, rd).to(dev)
        out = tool.unpack(tool.packet_traverse(packed, nodes, tris))
        t, slot, visits = out[0], out[1], out[4]
        ms = time_ms(lambda: tool.packet_traverse(packed, nodes, tris), n, dev,
                     graph=True)
        vis = visits.to(torch.float32)
        at_max = int((visits >= tool.MAX_VISITS).sum())
        print(f"T{tool.TOOL} {name}: {ms:.4f} ms -> {r / ms / 1e3:.1f} Mrays/s; "
              f"visits/packet mean {float(vis.mean()):.0f} max "
              f"{float(vis.max()):.0f} ({at_max} of {vis.numel()} packets at "
              f"MAX_VISITS {tool.MAX_VISITS}) [{label}]", flush=True)
        k = min(tool.N_CHECK, r)
        t_ref, tri_ref, _, _ = tw.closest_hit(
            sc, torch.tensor(ro[:k]).to(dev), torch.tensor(rd[:k]).to(dev))
        s = slot[:k].long()
        tri_new = torch.where(s >= 0, slot_tri[torch.clamp(s, min=0)], -1)
        ok_t = torch.isclose(torch.where(torch.isinf(t_ref), 1e30, t_ref),
                             torch.where(t[:k] >= 1e29, 1e30, t[:k]),
                             rtol=1e-3, atol=1e-3)
        t_match = float(ok_t.float().mean())
        tri_match = float((tri_new == tri_ref).float().mean())
        print(f"T{tool.TOOL} {name}: t match {t_match * 100:.2f}%  tri match "
              f"{tri_match * 100:.2f}% (first {k} rays against traverse_wide) "
              f"[{label}]", flush=True)
        res[name] = {"ms": ms, "mrays_s": r / ms / 1e3,
                     "visits_mean": float(vis.mean()),
                     "visits_max": float(vis.max()), "at_max_visits": at_max,
                     "t_match": t_match, "tri_match": tri_match, "out": out}
    return res


def main(variant: str = "all", device="cuda", r: int = N_RAYS, n: int = 10,
         scene=None) -> dict:
    """T3 on the tool's ray sets: see run_main."""
    return run_main(sys.modules[__name__], variant, device, r, n, scene)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
