"""Kernel lab T2: the dense cluster traversal prototype, on the card.

Port of tools/proto_cluster.py, which measured a cluster-dense traversal
kernel on synthetic clusters: rays in blocks of R_BLK (256 or 1024), stage
A box-tests every ray against every cluster box and counts the rays that
enter each, a compaction lists the entered clusters, stage B visits them
with Moller-Trumbore over each cluster's 128 triangles or with the tool's
"MXU" variant, a Plucker test whose edge and plane products are one matrix
product per cluster. csrc/lab_cluster.cu holds the function (the tie rule,
the modes) and the design.

proto_cluster() launches the kernel on a CUDA tensor and runs
proto_cluster_plain on a CPU tensor; it counts launches in `launches`.
synth() and probe_rays() are the tool's scene and rays, copied: the same
numpy draws give the same arrays. The tool's synth leaves the plane columns
of pk at zero, so its MXU job can never hit; with_planes() fills them with
random values for a check that reaches the Plucker test's hits.
adversarial_inputs() holds the cases that the tool's inputs do not reach:
equal t on several lanes of one cluster and in two clusters, a block that
enters no box, lists of many lengths, Cp 384, R_BLK 1024 with plane
columns.

    python -m hydracore_tpu_torch.tools.proto_cluster [all |
                                          full|novisit|stagea|empty ACT MXU RB]

prints, as the tool does, one line per job of 262,144 rays and C 256
clusters (all: the tool's eight jobs, in one process): visits per block, ms
(on the card the mean of n calls replayed from a CUDA graph), Mrays/s, us
per block and per visit, with the bound beside the card's name and power
limit.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from hydracore_tpu_torch.ops.intersect import safe_inv
from hydracore_tpu_torch.utils.build import CI, VP, launch, load_lib
from hydracore_tpu_torch.utils.device import resolve_device
from hydracore_tpu_torch.utils.lab import (bound_ms, check_tensor,
                                           device_label, time_ms)

K = 128  # triangles per cluster: the lanes
R_BLKS = (256, 1024)
N_RAYS = 262144
C = 256
BIG = 3.0e38
MODES = {"full": 0, "novisit": 1, "stagea": 2, "empty": 3}
# the tool's jobs: (variant, ACT, use_mxu, R_BLK)
JOBS = (("empty", 0, False, 256), ("empty", 0, False, 1024),
        ("novisit", 0, False, 1024),
        ("full", 4, False, 256), ("full", 16, False, 256),
        ("full", 4, False, 1024), ("full", 16, False, 1024),
        ("full", 16, True, 1024))
# f32 operations: a ray against a box (6 subtract-multiply pairs, 10
# min/max, 2 compares); a Moller-Trumbore lane (two cross products 18, four
# dot products 20, the divide, the subtraction of v0 3, three scalings 3, six
# compares); a Plucker lane (four 8-term dot products 60, tD 5, |tD| test
# and divide 2, t 1, nine compares)
OPS_BOX = 24
OPS_TRI = 51
OPS_PLUCKER = 77
# elements of one (blocks, rays, positions or lanes) temporary of the plain
# version
_STEP_ELEMS = 1 << 23

launches = 0

_lib = None


def reset_launch_counts() -> None:
    global launches
    launches = 0


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = load_lib("lab_cluster.cu", "hydra_lab_proto_cluster",
                        [VP] * 6 + [CI] * 5 + [VP])
    return _lib


def synth(C: int, ACT: int, seed: int = 0):
    """The tool's scene: ACT clusters of K small triangles around the origin
    cube, the other C - ACT a thousand units away; (cb (8, Cp), tris (Cp, 12,
    K), pk (Cp, 8, 4 K)) f32 numpy, Cp = C rounded up to 128. pk holds the
    Plucker columns of the three edges, [o x e, e, 0, 0]; its plane columns
    stay zero, as in the tool."""
    rng = np.random.default_rng(seed)
    Cp = (C + 127) // 128 * 128
    cb = np.zeros((8, Cp), np.float32)
    ctr = rng.uniform(-1, 1, (C, 3)).astype(np.float32)
    ctr[ACT:] += 1000.0
    half = 0.3
    cb[0:3, :C] = (ctr - half).T
    cb[3:6, :C] = (ctr + half).T
    cb[0:3, C:] = 1e30
    cb[3:6, C:] = -1e30
    v0 = (ctr[:, None, :] + rng.uniform(-half, half, (C, K, 3))).astype(np.float32)
    e1 = rng.uniform(-0.05, 0.05, (C, K, 3)).astype(np.float32)
    e2 = rng.uniform(-0.05, 0.05, (C, K, 3)).astype(np.float32)
    tris = np.zeros((Cp, 12, 128), np.float32)
    tris[:C, 0:3] = np.transpose(v0, (0, 2, 1))
    tris[:C, 3:6] = np.transpose(e1, (0, 2, 1))
    tris[:C, 6:9] = np.transpose(e2, (0, 2, 1))
    pk = np.zeros((Cp, 8, 512), np.float32)
    v1 = v0 + e1
    v2 = v0 + e2

    def edge_cols(a, b):
        e = b - a
        m = np.cross(a, e)
        return np.concatenate([m, e, np.zeros_like(e[..., :1]),
                               np.zeros_like(e[..., :1])], -1)  # (C, K, 8)

    pk[:C, :, 0:128] = np.transpose(edge_cols(v0, v1), (0, 2, 1))
    pk[:C, :, 128:256] = np.transpose(edge_cols(v1, v2), (0, 2, 1))
    pk[:C, :, 256:384] = np.transpose(edge_cols(v2, v0), (0, 2, 1))
    return cb, tris, pk


def with_planes(pk: np.ndarray, seed: int = 0) -> np.ndarray:
    """pk with random plane columns: row 6 (the coefficient of rp's 1) in
    [1, 3], the rest small normal values, so that tN = rp . plane is far
    from zero and half the lanes give t > 0."""
    rng = np.random.default_rng(seed)
    out = pk.copy()
    Cp = pk.shape[0]
    out[:, :, 384:512] = rng.normal(0.0, 0.1, (Cp, 8, 128)).astype(np.float32)
    out[:, 6, 384:512] = rng.uniform(1.0, 3.0, (Cp, 128)).astype(np.float32)
    return out


def _put_triangle(tris, pk, c: int, lane: int, v0, e1, e2) -> None:
    """Lane `lane` of cluster c becomes the triangle (v0, e1, e2), in tris
    and in pk's edge columns (synth's [o x e, e, 0, 0])."""
    v0, e1, e2 = (np.asarray(v, np.float32) for v in (v0, e1, e2))
    tris[c, 0:3, lane], tris[c, 3:6, lane], tris[c, 6:9, lane] = v0, e1, e2
    v1, v2 = v0 + e1, v0 + e2
    for k, (a, b) in enumerate(((v0, v1), (v1, v2), (v2, v0))):
        e = b - a
        pk[c, :, k * K + lane] = np.concatenate(
            [np.cross(a, e), e, np.zeros(2, np.float32)])


def probe_rays(r_blk: int, n_rays: int = N_RAYS, seed: int = 1) -> np.ndarray:
    """The tool's probe rays: n_rays origins uniform in [-1, 1]^3, normal
    directions, t_lim 1e30, in blocks (n_rays // r_blk, r_blk, 8) f32."""
    G = n_rays // r_blk
    rng = np.random.default_rng(seed)
    rays = np.zeros((G, r_blk, 8), np.float32)
    ro = rng.uniform(-1, 1, (G * r_blk, 3)).astype(np.float32)
    rd = rng.normal(size=(G * r_blk, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rays[:, :, 0:3] = ro.reshape(G, r_blk, 3)
    rays[:, :, 3:6] = rd.reshape(G, r_blk, 3)
    rays[:, :, 6] = 1e30
    rays[:, :, 7] = 1.0
    return rays


# the tied triangle of adversarial_inputs: a 1.2-unit right triangle in the
# plane z = 0.2 across the middle of the ray cloud, in these (cluster,
# lanes); both clusters are near ones, which every block of the tool's rays
# visits
TIE_TRIANGLE = ((-0.5, -0.5, 0.2), (1.2, 0.0, 0.0), (0.0, 1.2, 0.0))
TIE_LANES = ((2, (3, 40, 126, 127)), (9, (0, 127)))


def tie_scene(C: int = C, ACT: int = 16, planes: bool = False):
    """synth(C, ACT) with TIE_TRIANGLE in TIE_LANES: a ray that hits it has
    equal t on four lanes of cluster 2 (lane 127 must win) and the same t on
    two lanes of cluster 9, which must not replace it. With `planes`,
    with_planes() columns, the same in every tied lane (so their tN, t and
    ties agree too)."""
    cb, tris, pk = synth(C, ACT)
    if planes:
        pk = with_planes(pk)
    plane = pk[TIE_LANES[0][0], :, 3 * K + TIE_LANES[0][1][0]].copy()
    for c, lanes in TIE_LANES:
        for lane in lanes:
            _put_triangle(tris, pk, c, lane, *TIE_TRIANGLE)
            pk[c, :, 3 * K + lane] = plane
    return cb, tris, pk


def _point_rays(origins, t_lims, r_blk: int, seed: int = 2) -> np.ndarray:
    """One block of r_blk rays a row of `origins`, every ray of a block from
    its origin, normal directions, t_lim from `t_lims`."""
    rng = np.random.default_rng(seed)
    G = len(origins)
    rays = np.zeros((G, r_blk, 8), np.float32)
    rd = rng.normal(size=(G, r_blk, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=2, keepdims=True)
    rays[:, :, 0:3] = np.asarray(origins, np.float32)[:, None, :]
    rays[:, :, 3:6] = rd
    rays[:, :, 6] = np.asarray(t_lims, np.float32)[:, None]
    rays[:, :, 7] = 1.0
    return rays


ADVERSARIAL = ("ties", "ties_mxu", "no_entry", "lists", "lists_mxu", "cp384",
               "cp384_mxu", "planes_1024")


def adversarial_inputs() -> dict:
    """name -> (rays, cb, tris, pk, use_mxu), numpy f32, the cases that the
    tool's inputs do not reach (the first 2 blocks of 256 of the tool's
    rays, or its first block of 1024, where a case takes them):
      ties, ties_mxu  tie_scene: equal t on several lanes of one cluster
                      and in a later cluster (Plucker: with plane columns);
      no_entry        a block of the tool's rays, then one whose rays start
                      far from every box and point away: an empty list
                      beside a full one in one launch;
      lists, lists_mxu  tie_scene, 8 blocks each from one point with a
                      short t_lim: lists of 0, 1, 2, 6, 11 and 15 entries,
                      so the stage buffers wrap an odd and an even number
                      of times;
      cp384, cp384_mxu  synth(384, 24): Cp 384 (three 128-position tiles);
      planes_1024     R_BLK 1024 and the Plucker test with plane columns."""
    rays256 = probe_rays(256)[:2]
    out = {}
    for mxu in (False, True):
        tag = "_mxu" if mxu else ""
        scene = tie_scene(planes=mxu)
        out["ties" + tag] = (rays256,) + scene + (mxu,)
        rng = np.random.default_rng(5)
        origins = rng.uniform(-0.8, 0.8, (8, 3))
        lims = [0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 1.0, 1e30]
        out["lists" + tag] = (_point_rays(origins, lims, 256),) + scene + (mxu,)
        cb, tris, pk = synth(384, 24)
        out["cp384" + tag] = (rays256, cb, tris,
                              with_planes(pk) if mxu else pk, mxu)
    far = _point_rays([[50.0, 50.0, 50.0]], [1e30], 256)
    far[..., 0] += np.linspace(0.0, 1.0, 256, dtype=np.float32)
    far[..., 3:6] = (1.0, 0.0, 0.0)
    out["no_entry"] = ((np.concatenate([rays256[:1], far]),) + synth(C, 16)
                       + (False,))
    cb, tris, pk = synth(C, 16)
    out["planes_1024"] = (probe_rays(1024)[:1], cb, tris, with_planes(pk),
                          True)
    return {k: out[k] for k in ADVERSARIAL}


def _check(rays, cb, tris, pk, mode):
    check_tensor("rays", rays, torch.float32, (None, None, 8))
    if rays.shape[1] not in R_BLKS:
        raise ValueError(f"R_BLK must be 256 or 1024, got {rays.shape[1]}")
    check_tensor("cb", cb, torch.float32, (8, None), rays.device)
    Cp = cb.shape[1]
    if Cp == 0 or Cp % 128:
        raise ValueError(f"Cp {Cp}: not a positive multiple of 128")
    check_tensor("tris", tris, torch.float32, (Cp, 12, K), rays.device)
    check_tensor("pk", pk, torch.float32, (Cp, 8, 4 * K), rays.device)
    if mode not in MODES.values():
        raise ValueError(f"mode must be 0-3, got {mode}")
    if rays.is_cuda and any(a.data_ptr() % 16 for a in (rays, cb, tris, pk)):
        raise ValueError("rays, cb, tris and pk must be 16-byte aligned")


def _stage_a(rb, cb):
    """(g, Cp) i64: the rays of each block that enter each box."""
    ox, oy, oz = (rb[..., k:k + 1] for k in range(3))
    ix, iy, iz = (safe_inv(rb[..., k:k + 1]) for k in range(3, 6))
    t_lim = rb[..., 6:7]
    b = [cb[k][None, None, :] for k in range(6)]
    tx0, tx1 = (b[0] - ox) * ix, (b[3] - ox) * ix
    ty0, ty1 = (b[1] - oy) * iy, (b[4] - oy) * iy
    tz0, tz1 = (b[2] - oz) * iz, (b[5] - oz) * iz
    tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                     torch.minimum(ty0, ty1)),
                       torch.minimum(tz0, tz1))
    tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                     torch.maximum(ty0, ty1)),
                       torch.maximum(tz0, tz1))
    hit = (tf >= torch.clamp(tn, min=0.0)) & (tn < t_lim)
    return hit.sum(dim=1)


def _lanes_mt(r, blk, t_cur):
    """(k, R, 128) t and hit of the tool's Moller-Trumbore: rays r (k, R, 8)
    against triangle blocks blk (k, 12, 128)."""
    ox, oy, oz, dx, dy, dz = (r[..., j:j + 1] for j in range(6))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        blk[:, None, j] for j in range(9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = torch.where(det.abs() > 1e-12,
                      1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = (inv != 0.0) & (u >= 0) & (v >= 0) & (u + v <= 1.0) \
        & (t > 1e-5) & (t < t_cur)
    return t, hit


def _lanes_plucker(r, p, nrm, t_cur):
    """(k, R, 128) t and hit of the tool's MXU variant: w_k = sum over j, in
    index order, of rp[j] * p[:, j, k * 128 + lane], rp = [d, o x d, 1, 0 ox];
    tD = d . nrm (rows 0:3 of tris)."""
    ox, oy, oz, dx, dy, dz = (r[..., j:j + 1] for j in range(6))
    rp = [dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx,
          torch.ones_like(ox), ox * 0.0]

    def dot8(s):
        w = rp[0] * p[:, None, 0, s:s + K]
        for j in range(1, 8):
            w = w + rp[j] * p[:, None, j, s:s + K]
        return w

    w0, w1, w2, tN = (dot8(k * K) for k in range(4))
    tD = dx * nrm[:, None, 0] + dy * nrm[:, None, 1] + dz * nrm[:, None, 2]
    inv = torch.where(tD.abs() > 1e-12, 1.0 / tD, 0.0)
    t = tN * inv
    hit = (inv != 0.0) & (t > 1e-5) & (t < t_cur) & (
        ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)))
    return t, hit


def proto_cluster_plain(rays, cb, tris, pk, use_mxu: bool = False,
                        mode: int = 0):
    """The kernel's (out, outi) in plain PyTorch, a few ray blocks at a
    time: stage A's counts, the ascending list of entered clusters, and per
    visit the cluster's minimum t with its highest tied lane."""
    G, R, _ = rays.shape
    Cp = cb.shape[1]
    dev = rays.device
    lane = torch.arange(K, dtype=torch.int32, device=dev)
    step = max(1, _STEP_ELEMS // (R * max(Cp, K)))
    outs, outis = [], []
    for g0 in range(0, G, step):
        rb = rays[g0:g0 + step]
        g = rb.shape[0]
        t_cur = torch.minimum(rb[..., 6:7], torch.tensor(BIG, device=dev))
        slot = torch.full((g, R, 1), -1, dtype=torch.int32, device=dev)
        n_act = torch.zeros((g,), dtype=torch.int64, device=dev)
        if mode == 0:
            entered = _stage_a(rb, cb) > 0
            n_act = entered.sum(dim=1)
            pos = torch.arange(Cp, device=dev)
            lst = torch.sort(torch.where(entered, pos, Cp + pos), dim=1).values
            for i in range(int(n_act.max()) if g else 0):
                sel = torch.nonzero(n_act > i).flatten()
                c = lst[sel, i]
                if use_mxu:
                    t, hit = _lanes_plucker(rb[sel], pk[c], tris[c, 0:3],
                                            t_cur[sel])
                else:
                    t, hit = _lanes_mt(rb[sel], tris[c], t_cur[sel])
                tm = torch.where(hit, t, BIG)
                tmin = tm.amin(dim=2, keepdim=True)
                sl = torch.where(tm == tmin, c.int()[:, None, None] * K + lane,
                                 -1).amax(dim=2, keepdim=True)
                better = tmin < t_cur[sel]
                t_cur[sel] = torch.where(better, tmin, t_cur[sel])
                slot[sel] = torch.where(better, sl, slot[sel])
        na = n_act.to(torch.float32)[:, None, None].expand(g, R, 1)
        outs.append(torch.cat([t_cur, na] + [t_cur] * 6, dim=2))
        outis.append(slot.expand(g, R, 8))
    return torch.cat(outs), torch.cat(outis).contiguous()


def proto_cluster(rays, cb, tris, pk, use_mxu: bool = False, mode: int = 0):
    """rays (G, R_BLK, 8) f32 [o d t_lim 1], R_BLK 256 or 1024, cb (8, Cp),
    tris (Cp, 12, 128), pk (Cp, 8, 512) f32 -> (out (G, R_BLK, 8) f32 =
    [t, n_act, t x 6], outi (G, R_BLK, 8) i32 = slot x 8): the tool's
    run(rays, cb, tris, pk, use_mxu, mode). A CUDA tensor launches the
    kernel, a CPU tensor runs proto_cluster_plain."""
    _check(rays, cb, tris, pk, mode)
    if not rays.is_cuda:
        return proto_cluster_plain(rays, cb, tris, pk, use_mxu, mode)
    G, R, _ = rays.shape
    out = torch.empty(rays.shape, dtype=torch.float32, device=rays.device)
    outi = torch.empty(rays.shape, dtype=torch.int32, device=rays.device)
    launch(_kernel_lib(), "hydra_lab_proto_cluster", "proto-cluster",
           rays.device, rays.data_ptr(), cb.data_ptr(), tris.data_ptr(),
           pk.data_ptr(), out.data_ptr(), outi.data_ptr(), G, R, cb.shape[1],
           int(use_mxu), mode)
    global launches
    launches += 1
    return out, outi


def proto_cluster_bound_ms(rays, cb, out, use_mxu: bool,
                           mode: int) -> tuple[float, str]:
    """Bytes: rays in (32 a ray), out and outi (64 a ray), and once each the
    parts of cb, tris and pk that the mode reads (cb for stage A; for stage
    B the block of every visited cluster: tris (6 KiB) for Moller-Trumbore,
    pk and rows 0:3 of tris (17.5 KiB) for the Plucker test). Operations:
    OPS_BOX a ray and cluster position in stage A (modes 0-2), and in stage
    B OPS_TRI or OPS_PLUCKER a ray, lane and visit, visits from this run's
    n_act (out[:, 0, 1]); mode 3 reads only the rays."""
    G, R, _ = rays.shape
    Cp = cb.shape[1]
    n = G * R
    n_bytes = n * 96
    ops = 0
    if mode < 3:
        n_bytes += 6 * Cp * 4
        ops += n * Cp * OPS_BOX
    if mode == 0:
        n_act = out[:, 0, 1].to(torch.int64)
        # the visited blocks, read once: at least the longest list (every
        # block of synth's rays visits the same ACT near clusters)
        n_blocks = int(n_act.max()) if G else 0
        per_blk = (8 * 4 * K + 3 * K) * 4 if use_mxu else 12 * K * 4
        n_bytes += n_blocks * per_blk
        ops += int(n_act.sum()) * R * K * (OPS_PLUCKER if use_mxu else OPS_TRI)
    return bound_ms(n_bytes, ops)


def job_name(variant: str, act: int, use_mxu: bool, r_blk: int) -> str:
    return f"{variant} ACT={act} mxu={int(use_mxu)} rb={r_blk}"


def main(variant: str = "all", device="cuda", act: int = 16,
         use_mxu: bool = False, r_blk: int = 1024, n_rays: int = N_RAYS,
         c: int = C, n: int = 20) -> dict:
    """Run the tool's eight jobs ("all") or one (variant, act, use_mxu,
    r_blk) on n_rays probe rays and synth(c, ACT); returns {job_name: {"ms",
    "bound_ms", "bound_by", "n_act0", "hits", "out"}}, "out" the job's
    (out, outi) from its first call."""
    dev = resolve_device(device)
    if variant == "all":
        jobs = JOBS
    elif variant in MODES:
        jobs = ((variant, act, bool(use_mxu), r_blk),)
    else:
        raise ValueError(f"variant must be one of {list(MODES)} or 'all'")
    label = device_label(dev)
    rays_by_rb, scene_by_act = {}, {}
    res = {}
    for v, a, mxu, rb in jobs:
        if rb not in R_BLKS:
            raise ValueError(f"R_BLK must be 256 or 1024, got {rb}")
        if rb not in rays_by_rb:
            rays_by_rb[rb] = torch.tensor(probe_rays(rb, n_rays)).to(dev)
        if a not in scene_by_act:
            scene_by_act[a] = tuple(torch.tensor(x).to(dev) for x in synth(c, a))
        rays = rays_by_rb[rb]
        cb, tris, pk = scene_by_act[a]
        mode = MODES[v]
        out, outi = proto_cluster(rays, cb, tris, pk, mxu, mode)
        ms = time_ms(lambda: proto_cluster(rays, cb, tris, pk, mxu, mode), n,
                     dev, graph=True)
        bms, by = proto_cluster_bound_ms(rays, cb, out, mxu, mode)
        G = rays.shape[0]
        nv = float(out[0, 0, 1])
        hits = int((outi[:, :, 0] >= 0).sum())
        print(f"{v:8s} mxu={int(mxu)} rb={rb:5d} ACT={a:4d} vis/blk={nv:5.0f} "
              f"{ms:9.4f} ms {G * rb / ms / 1e3:8.1f} Mrays/s "
              f"{ms / G * 1e3:8.3f} us/blk "
              f"{ms / G / max(nv, 1e-9) * 1e3:7.3f} us/visit, hits {hits}, "
              f"bound {bms:.5f} ms ({by}) [{label}]", flush=True)
        res[job_name(v, a, mxu, rb)] = {"ms": ms, "bound_ms": bms,
                                        "bound_by": by, "n_act0": nv,
                                        "hits": hits, "out": (out, outi)}
    return res


if __name__ == "__main__":
    a = sys.argv[1:]
    if len(a) == 4:
        main(a[0], act=int(a[1]), use_mxu=bool(int(a[2])), r_blk=int(a[3]))
    else:
        main(a[0] if a else "all")
