"""Kernel lab T5: one cluster per ray block against one cluster per band.

Port of tools/proto_subvisit.py, which asked what a sub-group visit costs
against a plain one in the cluster kernel's inner loop. A plain visit tests
all 256 rays of a block against one cluster's Woop block (4, 384); a sub
step tests each group of 256 / n_bands rays against its own block, so one
step visits n_bands clusters. On the card a group is a band of threads:
one warp per cluster at 8 bands, two at 4 (csrc/lab_subvisit.cu holds the
function and the design).

The tool builds the sub operands in two ways, and they give two functions:
concat stacks the blocks band by band (ray k of a block in group
k // (256 / n_bands)); pltpu.repeat tiles the stacked rows (ray k in group
k % n_bands). subvisit(..., interleave=True) is the second.

subvisit() launches the kernel on a CUDA tensor and runs subvisit_plain on
a CPU tensor; it counts launches in plain_launches (n_bands 1) and
sub_launches (4 or 8). adversarial_inputs() holds the cases the tool's
normal draws do not reach.

    python -m hydracore_tpu_torch.tools.proto_subvisit [plain|sub8/repeat|
                                                        sub8/concat|
                                                        sub4/concat|all]

prints, as the tool does, each kernel's time at G 512, V 64, C 384 (on
the card the mean of n calls replayed from a CUDA graph), ns per visit or
step, and the ratio of a sub step to a plain visit, beside the
card's name and power limit.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from hydracore_tpu_torch.utils.build import CI, VP, launch, load_lib
from hydracore_tpu_torch.utils.device import resolve_device
from hydracore_tpu_torch.utils.lab import (bound_ms, check_tensor,
                                           device_label, time_ms)

R_BLK, G, V, C = 256, 512, 64, 384
BIG = 3.0e38
LANES = 128
# f32 operations for one ray against one lane: the w row's two dot
# products, the divide and the range test (u and v only for candidates):
# the rule of chip_smoke.py's OPS_LANE
OPS_LANE = 20
# ray blocks a step of the plain version takes: bounds its (blocks, 256,
# 384) temporaries to 25 MiB each
_BLOCKS_PER_STEP = 64
# the tool's rows: (name, n_bands, interleaved groups)
VARIANTS = {"plain": (1, False), "sub8/repeat": (8, True),
            "sub8/concat": (8, False), "sub4/concat": (4, False)}

# the profiling build's counts (subvisit(..., profile=))
PROFILE = ("walk iterations (a warp, a step: for each group of 32 lanes, "
           "its thread's most kept rays on one lane)", "kept ray-lanes")

plain_launches = 0
sub_launches = 0

_lib = None


def reset_launch_counts() -> None:
    global plain_launches, sub_launches
    plain_launches = sub_launches = 0


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = load_lib("lab_subvisit.cu", "hydra_lab_subvisit",
                        [VP, VP, VP, VP, CI, CI, CI, CI, VP])
        _lib.hydra_lab_subvisit_profile.argtypes = [VP, VP, VP, VP, CI, CI,
                                                    CI, CI, VP, VP]
        _lib.hydra_lab_subvisit_profile.restype = CI
    return _lib


def _check(rays, tris, lst, n_bands):
    check_tensor("rays", rays, torch.float32, (None, 8))
    check_tensor("tris", tris, torch.float32, (None, 4, 3 * LANES), rays.device)
    check_tensor("lst", lst, torch.int32, (None,), rays.device)
    if rays.shape[0] % R_BLK:
        raise ValueError(f"{rays.shape[0]} rays: not a multiple of {R_BLK}")
    if n_bands not in (1, 4, 8):
        raise ValueError(f"n_bands must be 1, 4 or 8, got {n_bands}")
    if lst.shape[0] % n_bands:
        raise ValueError(f"{lst.shape[0]} visits: not a multiple of {n_bands}")


def subvisit_plain(rays, tris, lst, n_bands: int = 1, interleave: bool = False):
    """The lane-tagged t of every ray (N, 1) in plain PyTorch, the tool's
    _mt over (blocks, groups, rays of a group, 384) operands, a few ray
    blocks at a time."""
    N = rays.shape[0]
    n_steps = lst.shape[0] // n_bands
    gs = R_BLK // n_bands
    # (block, group, ray of the group, column): ray k of a block sits at
    # (k // gs, k % gs), or (k % n_bands, k // n_bands) when interleaved
    r = rays.reshape(N // R_BLK, R_BLK, 8)
    r = (r.reshape(-1, gs, n_bands, 8).transpose(1, 2) if interleave
         else r.reshape(-1, n_bands, gs, 8))
    lane = torch.arange(LANES, dtype=torch.int32, device=rays.device)
    mask = torch.tensor(0xFFFFFF80 - (1 << 32), dtype=torch.int32)
    outs = []
    for b0 in range(0, r.shape[0], _BLOCKS_PER_STEP):
        rb = r[b0:b0 + _BLOCKS_PER_STEP]
        ox, oy, oz, dx, dy, dz = (rb[..., c:c + 1] for c in range(6))
        t_cur = torch.full(rb.shape[:-1] + (1,), BIG, dtype=torch.float32,
                           device=rays.device)
        for i in range(n_steps):
            blk = tris[lst[n_bands * i:n_bands * (i + 1)].long()]
            bx, by, bz, bc = (blk[None, :, None, k] for k in range(4))
            os_ = ox * bx + oy * by + oz * bz + bc
            ds_ = dx * bx + dy * by + dz * bz
            t = -os_[..., 256:384] / ds_[..., 256:384]
            u = os_[..., 0:128] + t * ds_[..., 0:128]
            v = os_[..., 128:256] + t * ds_[..., 128:256]
            hit = (t > 1e-5) & (t < t_cur) & (u >= 0) & (v >= 0) & (u + v <= 1.0)
            tm = torch.where(hit, t, BIG)
            tp = ((tm.view(torch.int32) & mask) | lane).view(torch.float32)
            t_cur = torch.minimum(t_cur, tp.amin(dim=-1, keepdim=True))
        outs.append(t_cur)
    t_cur = torch.cat(outs)
    if interleave:
        t_cur = t_cur.transpose(1, 2)
    return t_cur.reshape(N, 1)


def subvisit(rays, tris, lst, n_bands: int = 1, interleave: bool = False,
             profile=None):
    """rays (G * 256, 8) f32, tris (C, 4, 384) f32, lst (V,) i32 -> (G * 256,
    1) f32: n_bands 1 is the tool's make_plain(V), 4 or 8 its make_sub(V //
    n_bands, n_bands) with concat operands, or pltpu.repeat ones when
    interleave. A CUDA tensor launches the kernel, a CPU tensor runs
    subvisit_plain. On the card, `profile`, a zeroed int64 tensor (2,),
    runs the kernel's profiling build, which adds to it the warps' walk
    iterations and the kept ray-lanes (PROFILE)."""
    _check(rays, tris, lst, n_bands)
    if not rays.is_cuda:
        if profile is not None:
            raise ValueError("the profile is the kernel's: a CUDA tensor")
        return subvisit_plain(rays, tris, lst, n_bands, interleave)
    N = rays.shape[0]
    out = torch.empty((N, 1), dtype=torch.float32, device=rays.device)
    args = (rays.data_ptr(), tris.data_ptr(), lst.data_ptr(), out.data_ptr(), N,
            lst.shape[0] // n_bands, n_bands, int(interleave))
    if profile is None:
        launch(_kernel_lib(), "hydra_lab_subvisit", "sub-visit", rays.device,
               *args)
    else:
        check_tensor("profile", profile, torch.int64, (len(PROFILE),),
                     rays.device)
        launch(_kernel_lib(), "hydra_lab_subvisit_profile",
               "sub-visit (profile)", rays.device, *args, profile.data_ptr())
    global plain_launches, sub_launches
    if n_bands == 1:
        plain_launches += 1
    else:
        sub_launches += 1
    return out


def subvisit_bound_ms(n_rays: int, lst, n_bands: int = 1) -> tuple[float, str]:
    """Bytes: rays in (32 bytes each), out (4), the list and the blocks it
    names once; operations: OPS_LANE for every lane of the len(lst) /
    n_bands visits each ray makes."""
    n_blocks = int(lst.unique().numel())
    n_bytes = n_rays * 36 + lst.shape[0] * 4 + n_blocks * 4 * 3 * LANES * 4
    return bound_ms(n_bytes,
                    n_rays * (lst.shape[0] // n_bands) * LANES * OPS_LANE)


def inputs(g: int = G, v: int = V, c: int = C, seed: int = 0, device="cuda"):
    """The tool's inputs: normal rays (g * 256, 8) and blocks (c, 4, 384),
    a visit list of v uniform ids in [0, c)."""
    rng = np.random.default_rng(seed)
    rays = rng.normal(size=(g * R_BLK, 8)).astype(np.float32)
    tris = rng.normal(size=(c, 4, 3 * LANES)).astype(np.float32)
    lst = rng.integers(0, c, size=(v,)).astype(np.int32)
    return tuple(torch.tensor(a).to(device) for a in (rays, tris, lst))


# the cases adversarial_inputs() holds, in order
ADVERSARIAL = ("zeros", "bounds", "subnormal")
ADV_G, ADV_V, ADV_C = 4, 16, 8  # ray blocks, visits and Woop blocks a case
BIG_BITS = int(np.float32(BIG).view(np.int32))
TAG_MASK = -128  # 0xFFFFFF80 as an int32


def _f32(bits) -> np.ndarray:
    return np.asarray(bits, np.int32).view(np.float32)


def _axis_rays(rng, n: int) -> np.ndarray:
    """n rays (n, 8) with origins of signed zeros (a quarter of them with one
    component +-1 or 0.5) and directions +-e_x, +-e_y or +-e_z with signed
    zeros elsewhere, so that against rows of small dyadic values ow and dw
    hold at most one rounding (the last sum) and u and v none: every order
    of rounding gives the same values. Every eighth ray has a direction of
    signed zeros only (dw = +-0 on every lane: it misses every lane)."""
    sz = np.array([0.0, -0.0], np.float32)
    rays = np.zeros((n, 8), np.float32)
    rays[:, 0:3] = rng.choice(sz, (n, 3))
    moved = np.flatnonzero(rng.random(n) < 0.25)
    rays[moved, rng.integers(0, 3, moved.size)] = rng.choice(
        np.array([1.0, -1.0, 0.5], np.float32), moved.size)
    d = rng.choice(sz, (n, 3))
    axis = rng.integers(0, 3, n)
    live = np.arange(n) % 8 != 7
    d[live, axis[live]] = rng.choice(np.array([1.0, -1.0], np.float32),
                                     int(live.sum()))
    rays[:, 3:6] = d
    return rays


def _blocks(rng, w_xyz, w_c, uv_c, n: int = ADV_C) -> np.ndarray:
    """n Woop blocks (n, 4, 384) whose lanes draw their w row's x, y, z from
    w_xyz and c from w_c, and their u and v rows' c (a pair) from uv_c, the
    u and v rows' x, y, z signed zeros: for an axis ray from the origin t =
    -c_w / w_axis, u = c_u and v = c_v (t * +-0 added)."""
    sz = np.array([0.0, -0.0], np.float32)
    tris = rng.choice(sz, (n, 4, 3 * LANES))
    tris[:, 0:3, 256:384] = rng.choice(np.asarray(w_xyz, np.float32),
                                       (n, 3, LANES))
    tris[:, 3, 256:384] = rng.choice(np.asarray(w_c, np.float32), (n, LANES))
    uv = np.asarray(uv_c, np.float32)[rng.integers(0, len(uv_c), (n, LANES))]
    tris[:, 3, 0:128], tris[:, 3, 128:256] = uv[..., 0], uv[..., 1]
    return tris


# (u, v) pairs: inside the triangle (on its edges too: u or v +-0, u + v =
# 1) and just outside it
UV_HIT = [(0.25, 0.25), (0.0, 0.0), (-0.0, 1.0), (0.5, 0.5), (1.0, -0.0),
          (0.125, 0.875)]
UV_MISS = [(0.5, float(np.nextafter(np.float32(0.5), np.float32(1)))),
           (-1e-30, 0.5), (0.75, 0.5)]


def _zeros(rng):
    """-0.0 in rays and rows; dw = +-0 with ow = +-0 (t NaN) and with ow !=
    0 (t +-inf); block 0 offers no candidate (w's x, y, z signed zeros, c
    nonzero); the rays with a zero direction miss every lane, so their
    output is BIG's masked bits."""
    tris = _blocks(rng, [0.0, -0.0, 1.0, -1.0, 2.0],
                   [0.0, -0.0, -1.0, -0.5, 1.0, -2.0, -0.25],
                   UV_HIT + UV_MISS)
    tris[0, 0:3, 256:384] = rng.choice(np.array([0.0, -0.0], np.float32),
                                       (3, LANES))
    tris[0, 3, 256:384] = rng.choice(np.array([1.0, -1.0, 0.5], np.float32),
                                     LANES)
    return tris


def _bounds(rng):
    """t exactly at 1e-5 (c_w -1e-5 over 1, or -2e-5 over 2) and one ulp
    either side; lanes 0-31 of every block at t = bits 0x40000000 | l, so a
    ray whose winner was such a lane meets t == its tagged t_cur at that
    lane in its next step, and the lanes below it hit again; t one ulp
    below BIG, at BIG, past BIG and at BIG's masked bits | 5; ties of t
    between lanes 2k and 2k + 1 above lane 63 (the lower lane wins); the
    rest small dyadic t."""
    one = np.float32(1e-5)
    tiny = [one, np.nextafter(one, np.float32(1)), np.nextafter(one, np.float32(0))]
    tris = _blocks(rng, [1.0, 1.0, 2.0, 0.5, -1.0],
                   [-0.5, -1.0, -2.0, -0.25, -0.375, -3.0, 1.0],
                   UV_HIT + UV_HIT + UV_MISS)
    lanes = np.arange(32)
    tris[:, 0:3, 256:288] = 1.0
    tris[:, 3, 256:288] = -_f32(0x40000000 | lanes)
    special = ([(1.0, -t) for t in tiny] + [(2.0, -2 * one)]
               + [(1.0, -_f32(BIG_BITS - 1)), (1.0, -np.float32(BIG)),
                  (1.0, -np.float32(3.4e38)), (1.0, -_f32((BIG_BITS & TAG_MASK) | 5)),
                  (0.5, -np.float32(3e38))])
    for i, (a, c) in enumerate(special):
        tris[:, 0:3, 256 + 32 + i] = a
        tris[:, 3, 256 + 32 + i] = c
    ladder = _f32(0x40000000 + rng.integers(0, 256, (ADV_C, 32)))
    tris[:, 3, 256 + 96:384] = -ladder
    for k in range(64, 128, 2):
        tris[:, :, [k, 128 + k, 256 + k + 1]] = tris[:, :, [k, 128 + k, 256 + k]]
        tris[:, :, 128 + k + 1] = tris[:, :, 128 + k]
        tris[:, :, k + 1] = tris[:, :, k]
    return tris


def _subnormal(rng):
    """Subnormal dw and ow: w's x, y, z drawn among subnormals (1e-40,
    2^-149, 1e-38) and 1, c among subnormals, the least normal 2^-126 and
    small normals, so that t = -ow / dw is 1 (a subnormal over itself),
    tiny, huge or infinite. No product or sum of two normal values comes
    out subnormal, so flushing the inputs' subnormals to zero gives what a
    machine that flushes every subnormal computes (tests/test_torch_lab.py
    holds XLA:CPU so)."""
    sub = [1e-40, -1e-40, 2.0 ** -149, 1e-38, 1.0]
    return _blocks(rng, sub, [-1e-40, 1e-40, -(2.0 ** -149), -1e-35, -1.0,
                              -(2.0 ** -126), -0.5, -1e-38],
                   UV_HIT + UV_MISS)


def adversarial_inputs(device="cpu") -> dict:
    """name -> (rays, tris, lst) on `device`, ADV_G ray blocks of axis rays
    (_axis_rays) against ADV_C blocks in a list of ADV_V visits (every
    block twice, shuffled: plain steps, sub8 and sub4 groups all meet
    several): "zeros" (_zeros), "bounds" (_bounds), "subnormal"
    (_subnormal)."""
    out = {}
    for i, name in enumerate(ADVERSARIAL):
        rng = np.random.default_rng(40 + i)
        tris = {"zeros": _zeros, "bounds": _bounds,
                "subnormal": _subnormal}[name](rng)
        rays = _axis_rays(rng, ADV_G * R_BLK)
        lst = rng.permutation(np.tile(np.arange(ADV_C), ADV_V // ADV_C))
        out[name] = tuple(torch.tensor(a).to(device) for a in
                          (rays, tris.astype(np.float32), lst.astype(np.int32)))
    return out


def main(variant: str = "all", device="cuda", g: int = G, v: int = V,
         c: int = C, n: int = 4) -> dict:
    """Time the chosen kernels on the tool's inputs (the plain kernel always,
    as the yardstick of the ratio); returns {variant: {"ms", "bound_ms",
    "bound_by"}}."""
    dev = resolve_device(device)
    if variant != "all" and variant not in VARIANTS:
        raise ValueError(f"variant must be one of {list(VARIANTS)} or 'all'")
    names = list(VARIANTS) if variant == "all" else sorted({"plain", variant},
                                                           key=list(VARIANTS).index)
    rays, tris, lst = inputs(g, v, c, device=dev)
    label = device_label(dev)
    out = {}
    for name in names:
        n_bands, inter = VARIANTS[name]
        bms, by = subvisit_bound_ms(rays.shape[0], lst, n_bands)
        ms = time_ms(lambda: subvisit(rays, tris, lst, n_bands, inter), n, dev,
                     graph=True)
        out[name] = {"ms": ms, "bound_ms": bms, "bound_by": by}
        if n_bands == 1:
            print(f"plain      : {v} visits x {g} blocks: {ms:8.3f} ms "
                  f"({ms / g / v * 1e6:6.1f} ns/visit), bound {bms:.4f} ms "
                  f"({by}) [{label}]", flush=True)
            continue
        ns = v // n_bands
        ratio = (ms / ns) / (out["plain"]["ms"] / v)
        print(f"{name:11s}: {ns} steps x {g} blocks: {ms:8.3f} ms "
              f"({ms / g / ns * 1e6:6.1f} ns/step, ratio vs plain visit "
              f"{ratio:.2f}; <2 => wins on divergent wavefronts), bound "
              f"{bms:.4f} ms ({by}) [{label}]", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
