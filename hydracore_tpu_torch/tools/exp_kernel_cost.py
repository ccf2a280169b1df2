"""Kernel lab T1: where a cluster kernel's time goes, on the card.

Port of tools/exp_kernel_cost.py. Variants of a cut-down cluster kernel
(csrc/lab_cluster_cost.cu: one CTA per block of 256 rays; the scans put the
cluster positions on the lanes, see its header) run on the eye rays of a
512 x 512 frame in Morton order, G = 1024 blocks:

  floor      copy the rays to out, zeros to outi: I/O only
  fmN        floor with N ray blocks per CTA
  stageaN    N box scans over the octant's cluster positions, ending at
             once in a block without a live ray as B1's, occupancy words in
             shared memory; out = N * word 0
  compactN   one scan, then N sweeps that list the entered positions;
             out = N * their count
  full       kernel B1 itself, ops/traverse_cluster.cluster_traverse

cluster_cost() launches the lab kernel on a CUDA tensor and runs the plain
versions on a CPU tensor; it counts launches in floor_launches (floor and
fmN), stagea_launches and compact_launches. adversarial_inputs() holds the
cases the tool's rays do not reach (NaN origins, |d| < 1e-12, boxes at
+-1e30, inverted boxes, blocks with no or one live ray, Cp 400). The scene is the port's
bench_scene at 512 x 512 (a flat pool, Cp 384), standing in for the
reference's test_224 that the JAX tool loaded.

    python -m hydracore_tpu_torch.tools.exp_kernel_cost [floor|fmN|stageaN|
                                                         compactN|full|all]

prints, as the tool does, ms and us per block for each variant (on the
card the mean of n calls replayed from a CUDA graph, so that the host's
time to issue a call is not in it) beside the card's name and power limit,
and with "all" the split of the whole kernel's time: scan (stagea1 - floor), compaction (compact1 - stagea1) and
the rest, staging and Moller-Trumbore (full - compact1), each as a share of
full. The lab variants scan every cluster position, as B1 did before its
two-level walk over groups of clusters; B1 now walks the groups first, so
the split describes that single-level walk and "full - compact1" is no
longer B1's own staging and Moller-Trumbore (it may come out negative).
"""
from __future__ import annotations

import re
import sys

import numpy as np
import torch

from hydracore_tpu_torch.integrators import pt
from hydracore_tpu_torch.ops import traverse_cluster as tc
from hydracore_tpu_torch.scene.procedural import bench_scene
from hydracore_tpu_torch.utils.build import CI, VP, launch, load_lib
from hydracore_tpu_torch.utils.device import resolve_device
from hydracore_tpu_torch.utils.lab import (bound_ms, check_tensor,
                                           device_label, time_ms)

R_BLK = 256
W = 512
# the slab test of one ray against one box: 6 mul-sub pairs, 10 min/max,
# 2 compares (chip_smoke.py's OPS_BOX)
OPS_BOX = 24
KINDS = {"floor": 0, "stagea": 1, "compact": 2}
ALL = ("floor", "fm2", "fm4", "stagea1", "stagea2", "compact1", "compact2",
       "full")
# elements of one (blocks, rays, axes, positions) temporary of the plain scan
_STEP_ELEMS = 1 << 23

floor_launches = 0
stagea_launches = 0
compact_launches = 0

_lib = None


def reset_launch_counts() -> None:
    global floor_launches, stagea_launches, compact_launches
    floor_launches = stagea_launches = compact_launches = 0


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = load_lib("lab_cluster_cost.cu", "hydra_lab_cluster_cost",
                        [VP, VP, VP, VP, VP, CI, CI, CI, CI, CI, VP])
    return _lib


def parse(variant: str) -> tuple[str, int]:
    """"stagea2" -> ("stagea", 2), "fm4" -> ("fm", 4), "floor" -> ("floor",
    1), "full" -> ("full", 1)."""
    m = re.fullmatch(r"(floor|full)|(fm|stagea|compact)(\d+)", variant)
    if m is None:
        raise ValueError(f"unknown variant {variant!r}: floor, fmN, stageaN, "
                         "compactN, full or all")
    return (m.group(1), 1) if m.group(1) else (m.group(2), int(m.group(3)))


def entered_positions(rays, oct_, cbl_oct):
    """(G, (Cp // 128) * 128) bool: whether some ray of the block enters the
    box at each position of the block's octant order, by the tool's slab
    test (unsigned eps, no liveness test of the ray); none in a block
    without a live ray, whose scan ends at once, as B1's does."""
    G = rays.shape[0]
    n_pos = cbl_oct.shape[-1] // 128 * 128
    o, d, t_act = rays[..., 0:3], rays[..., 3:6], rays[..., 6:7]
    inv = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)
    oi = o * inv
    zero = torch.zeros((), dtype=torch.float32, device=rays.device)
    step = max(1, _STEP_ELEMS // (rays.shape[1] * 3 * max(n_pos, 1)))
    out = []
    for s in range(0, G, step):
        b = cbl_oct[oct_[s:s + step].long(), :, :n_pos]  # (g, 8, n_pos)
        i, oo = inv[s:s + step, :, :, None], oi[s:s + step, :, :, None]
        t0 = b[:, None, 0:3] * i - oo  # (g, 256, 3, n_pos)
        t1 = b[:, None, 3:6] * i - oo
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = torch.maximum(torch.maximum(lo[:, :, 0], lo[:, :, 1]), lo[:, :, 2])
        tf = torch.minimum(torch.minimum(hi[:, :, 0], hi[:, :, 1]), hi[:, :, 2])
        hit = (tf >= torch.maximum(tn, zero)) & (tn < t_act[s:s + step])
        out.append(hit.any(dim=1))
    live = (rays[..., 7] > 0).any(dim=1)
    return torch.cat(out) & live[:, None]


def cluster_cost_plain(kind: str, rays, oct_, cbl_oct, n: int = 1):
    """The lab kernel's (out, outi) in plain PyTorch."""
    outi = torch.zeros(rays.shape, dtype=torch.int32, device=rays.device)
    if kind in ("floor", "fm"):
        return rays.clone(), outi
    hit = entered_positions(rays, oct_, cbl_oct)
    if kind == "stagea":
        bits = torch.arange(16, device=rays.device)
        val = (hit[:, :16].long() << bits).sum(dim=1)
    else:
        val = hit.sum(dim=1)
    val = (n * val).to(torch.float32)
    return val[:, None, None].expand(rays.shape).contiguous(), outi


def cluster_cost(kind: str, rays, oct_, cbl_oct, n: int = 1):
    """kind "floor", "fm" (n ray blocks per CTA), "stagea" (n scans) or
    "compact" (n sweeps) on rays (G, 256, 8) f32, oct_ (G,) i32 and cbl_oct
    (8, 8, Cp) f32 -> (out (G, 256, 8) f32, outi (G, 256, 8) i32). A CUDA
    tensor launches the lab kernel, a CPU tensor runs cluster_cost_plain."""
    if kind not in ("floor", "fm", "stagea", "compact"):
        raise ValueError(f"unknown kind {kind!r}")
    check_tensor("rays", rays, torch.float32, (None, R_BLK, 8))
    G = rays.shape[0]
    check_tensor("oct_", oct_, torch.int32, (G,), rays.device)
    check_tensor("cbl_oct", cbl_oct, torch.float32, (8, 8, None), rays.device)
    if cbl_oct.shape[2] < 128:
        raise ValueError(f"Cp {cbl_oct.shape[2]} < 128: no position to scan")
    if kind == "fm" and G % n:
        raise ValueError(f"{G} blocks: not a multiple of {n}")
    if not rays.is_cuda:
        return cluster_cost_plain(kind, rays, oct_, cbl_oct, n)
    out = torch.empty(rays.shape, dtype=torch.float32, device=rays.device)
    outi = torch.empty(rays.shape, dtype=torch.int32, device=rays.device)
    code = KINDS["floor" if kind == "fm" else kind]
    launch(_kernel_lib(), "hydra_lab_cluster_cost", f"lab {kind}",
           rays.device, rays.data_ptr(), oct_.data_ptr(), cbl_oct.data_ptr(),
           out.data_ptr(), outi.data_ptr(), G, cbl_oct.shape[2], code,
           1 if kind == "fm" else n, n if kind == "fm" else 1)
    global floor_launches, stagea_launches, compact_launches
    if code == 0:
        floor_launches += 1
    elif code == 1:
        stagea_launches += 1
    else:
        compact_launches += 1
    return out, outi


def lab_rays(scene, w: int = W):
    """The tool's rays: the eye rays of a w x w frame through pixel centres
    in Morton order, in ray blocks (t_lim 1e30, all active), and the octant
    of each block's first ray."""
    dev = scene.tri_attr.device
    order = torch.tensor(pt._morton_pixel_order(w, w).astype("int64"),
                         device=dev)
    px, py = (order % w).to(torch.int32), (order // w).to(torch.int32)
    half = torch.full((w * w, 2), 0.5, dtype=torch.float32, device=dev)
    ro, rd = pt.make_eye_rays(scene.camera, px, py, half, half)
    rays, _ = tc._to_blocks(ro, rd, 1e30, None, R_BLK)
    d0 = rays[:, 0, 3:6]
    oct_ = ((d0[:, 0] > 0).to(torch.int32) + 2 * (d0[:, 1] > 0).to(torch.int32)
            + 4 * (d0[:, 2] > 0).to(torch.int32))
    return rays, oct_


# the cases adversarial_inputs() holds, in order
ADVERSARIAL = ("mixed", "cp400")


def _adv_boxes(rng, Cp: int) -> np.ndarray:
    """(8, 8, Cp) f32: each octant's boxes, random in [-2, 2]^3 (rows 6, 7
    zero)."""
    lo = rng.uniform(-2.0, 2.0, (8, 3, Cp))
    b = np.zeros((8, 8, Cp), np.float32)
    b[:, 0:3] = lo
    b[:, 3:6] = lo + rng.uniform(0.05, 1.0, (8, 3, Cp))
    return b


def _adv_rays(rng, n: int) -> np.ndarray:
    """(n, 8) f32 rays [o d t_lim active]: origins in [-3, 3]^3, normal
    directions, t_lim 1e30, all active."""
    r = np.zeros((n, 8), np.float32)
    r[:, 0:3] = rng.uniform(-3.0, 3.0, (n, 3))
    r[:, 3:6] = rng.normal(size=(n, 3))
    r[:, 6] = 1e30
    r[:, 7] = 1.0
    return r


def adversarial_inputs(device="cpu") -> dict:
    """name -> (rays (G, 256, 8), oct_ (G,) i32, cbl_oct (8, 8, Cp)) f32 on
    `device`, the cases the tool's rays do not reach:
      mixed  Cp 384: each octant's positions 1-4 (word 0, what stageaN
             returns) and every 37th hold a box of +-1e30, an inverted box
             (bmin > bmax), a box at 1e30 and a half-space box; 8 blocks:
             0 no live ray, 1 one live ray, 2 |d| < 1e-12 of both signs and
             d = -0.0 (the unsigned eps), 3 one NaN origin component a ray,
             4 origins at +-1e30 (t = inf - inf = NaN for tiny d), 5 t_lim
             0, -1, NaN and 1e30, 6-7 plain random rays;
      cp400  Cp 400: 384 positions scanned, positions 384-399 boxes that
             every ray enters (an unscanned tail), 4 blocks of random rays."""
    rng = np.random.default_rng(31)
    big = np.float32(1e30)
    b = _adv_boxes(rng, 384)
    for at in list(range(1, 5)) + list(range(37, 384, 37)):
        kind = at % 4
        if kind == 1:    # everything
            b[:, 0:3, at], b[:, 3:6, at] = -big, big
        elif kind == 2:  # inverted
            b[:, 0:3, at], b[:, 3:6, at] = b[:, 3:6, at].copy(), b[:, 0:3, at].copy()
        elif kind == 3:  # far away at 1e30
            b[:, 0:3, at], b[:, 3:6, at] = big, 2 * big
        else:            # a half space x >= -1
            b[:, 0:3, at] = (-1.0, -big, -big)
            b[:, 3:6, at] = big
    rays = _adv_rays(rng, 8 * R_BLK).reshape(8, R_BLK, 8)
    rays[0, :, 7] = 0.0
    rays[1, :, 7] = 0.0
    rays[1, 77, 7] = 1.0
    tiny = np.array([1e-13, -1e-13, 5e-13, -5e-13, -0.0, 0.0, 1e-12, -1e-12],
                    np.float32)
    k = np.arange(R_BLK)
    for axis in range(3):
        rays[2, :, 3 + axis] = np.where((k >> axis) % 2 == 0, tiny[(k + axis) % 8],
                                        rays[2, :, 3 + axis])
    rays[3, k, k % 3] = np.nan
    rays[4, :, 0:3] = np.where(rng.uniform(size=(R_BLK, 3)) < 0.5, -big, big)
    rays[4, :, 3:6] = np.where(k[:, None] % 2 == 0, tiny[k % 8][:, None],
                               rays[4, :, 3:6])
    rays[5, :, 6] = np.array([0.0, -1.0, np.nan, 1e30], np.float32)[k % 4]
    oct_ = np.array([0, 1, 2, 3, 4, 5, 6, 7], np.int32)
    b4 = _adv_boxes(rng, 400)
    b4[:, 0:3, 384:], b4[:, 3:6, 384:] = -big, big
    rays4 = _adv_rays(rng, 4 * R_BLK).reshape(4, R_BLK, 8)
    oct4 = np.array([7, 0, 3, 4], np.int32)
    cases = {"mixed": (rays, oct_, b), "cp400": (rays4, oct4, b4)}
    return {k: tuple(torch.tensor(x).to(device) for x in cases[k])
            for k in ADVERSARIAL}


def variant_bound_ms(kind: str, n: int, rays, cbl_oct) -> tuple[float, str]:
    """floor / fm: rays in, out and outi written; stagea: n scans of
    OPS_BOX per ray and position; compact: one scan (its sweeps are a few
    operations per word)."""
    n_rays = rays.shape[0] * rays.shape[1]
    n_bytes = n_rays * 8 * 4 * 3
    if kind in ("floor", "fm"):
        return bound_ms(n_bytes, 0)
    n_pos = cbl_oct.shape[2] // 128 * 128
    scans = n if kind == "stagea" else 1
    return bound_ms(n_bytes + cbl_oct.numel() * 4,
                    scans * n_rays * n_pos * OPS_BOX)


def run_variant(variant: str, rays, oct_, scene):
    """One call of the variant: the lab kernel, or B1 for "full"."""
    kind, n = parse(variant)
    if kind == "full":
        return tc.cluster_traverse(rays, **tc.scene_pool(scene))
    return cluster_cost(kind, rays, oct_, scene.cl_bounds_oct, n)


def main(variant: str = "all", device="cuda", w: int = W, n: int = 20) -> dict:
    """Time the chosen variants (each over n calls) on bench_scene(w, w);
    returns {variant: {"ms", "bound_ms", "bound_by"}} (no bound for full:
    chip_smoke.py computes B1's) and, with "all", "split": {part: share of
    full}."""
    dev = resolve_device(device)
    names = list(ALL) if variant == "all" else [variant]
    for v in names:
        parse(v)
    scene = bench_scene(w, w).to(dev)
    rays, oct_ = lab_rays(scene, w)
    G = rays.shape[0]
    label = device_label(dev)
    out = {}
    for v in names:
        ms = time_ms(lambda: run_variant(v, rays, oct_, scene), n, dev,
                     graph=True)
        kind, k = parse(v)
        rec = {"ms": ms, "bound_ms": None, "bound_by": None}
        note = ""
        if kind != "full":
            rec["bound_ms"], rec["bound_by"] = variant_bound_ms(
                kind, k, rays, scene.cl_bounds_oct)
            note = f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
        print(f"{v:12s}: {ms:8.4f} ms  {ms / G * 1e3:7.3f} us/blk{note} "
              f"[{label}]", flush=True)
        out[v] = rec
    if {"floor", "stagea1", "compact1", "full"} <= set(names):
        full = out["full"]["ms"]
        parts = {"floor (I/O)": out["floor"]["ms"],
                 "scan (stagea1 - floor)": out["stagea1"]["ms"] - out["floor"]["ms"],
                 "compaction (compact1 - stagea1)":
                     out["compact1"]["ms"] - out["stagea1"]["ms"],
                 "staging + Moller-Trumbore (full - compact1)":
                     full - out["compact1"]["ms"]}
        out["split"] = {k: v / full for k, v in parts.items()}
        print("split of full (" + f"{full:.4f} ms): " + ", ".join(
            f"{k} {v:.4f} ms = {100 * v / full:.1f}%" for k, v in parts.items())
            + f" [{label}]", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
