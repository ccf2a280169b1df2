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
sub_launches (4 or 8).

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


def subvisit(rays, tris, lst, n_bands: int = 1, interleave: bool = False):
    """rays (G * 256, 8) f32, tris (C, 4, 384) f32, lst (V,) i32 -> (G * 256,
    1) f32: n_bands 1 is the tool's make_plain(V), 4 or 8 its make_sub(V //
    n_bands, n_bands) with concat operands, or pltpu.repeat ones when
    interleave. A CUDA tensor launches the kernel, a CPU tensor runs
    subvisit_plain."""
    _check(rays, tris, lst, n_bands)
    if not rays.is_cuda:
        return subvisit_plain(rays, tris, lst, n_bands, interleave)
    N = rays.shape[0]
    out = torch.empty((N, 1), dtype=torch.float32, device=rays.device)
    launch(_kernel_lib(), "hydra_lab_subvisit", "sub-visit", rays.device,
           rays.data_ptr(), tris.data_ptr(), lst.data_ptr(), out.data_ptr(), N,
           lst.shape[0] // n_bands, n_bands, int(interleave))
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
