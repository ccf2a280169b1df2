"""Kernel lab T7: throughput of random row gathers on the card.

Port of tools/bench_pallas_gather.py, which asked whether per-ray row
gathers from an on-chip node pool are fast enough for a per-ray traversal.
For a pool (S, 128) f32 and indices idx (R, 1) i32 both of its kernels
compute

    out[r] = sum over it < ITERS of pool[(idx[r] + it) % S]

the "taa" one over the rows as they are, the "onehot" one over the rows
rounded to bf16 (what its one-hot bf16 matmul with f32 accumulation
gives). gather() launches csrc/lab_gather.cu on a CUDA tensor (one warp per
output row; the 2 MiB pool stays in L2) and runs gather_plain on a CPU
tensor; it counts launches in gather_launches / onehot_launches.

    python -m hydracore_tpu_torch.tools.bench_pallas_gather [taa|onehot|all]

prints, for each kernel, its time at the tool's size (S 4096, R 262,144,
16 iterations; on the card the mean of n calls replayed from a CUDA graph),
rows per second and ns per row, beside the card's name and power limit.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from hydracore_tpu_torch.utils.build import CI, VP, launch, load_lib
from hydracore_tpu_torch.utils.device import resolve_device
from hydracore_tpu_torch.utils.lab import (bound_ms, check_tensor,
                                           device_label, time_ms)

S = 4096       # pool rows (node pool)
R = 262144     # total rays
ITERS = 16     # gathers per ray
COLS = 128

VARIANTS = {"taa": False, "onehot": True}

gather_launches = 0
onehot_launches = 0

_lib = None


def reset_launch_counts() -> None:
    global gather_launches, onehot_launches
    gather_launches = onehot_launches = 0


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = load_lib("lab_gather.cu", "hydra_lab_gather",
                        [VP, VP, VP, CI, CI, CI, CI, VP])
    return _lib


def gather_plain(pool, idx, iters: int = ITERS, onehot: bool = False):
    """The gather-sum in plain PyTorch, summed in iteration order."""
    rows = pool.to(torch.bfloat16).to(torch.float32) if onehot else pool
    i0 = idx.reshape(-1).to(torch.int64)
    acc = torch.zeros((i0.numel(), pool.shape[1]), dtype=torch.float32,
                      device=pool.device)
    for it in range(iters):
        acc = acc + rows[(i0 + it) % pool.shape[0]]
    return acc


def gather(pool, idx, iters: int = ITERS, onehot: bool = False):
    """pool (S, 128) f32, idx (R, 1) i32 -> (R, 128) f32. A CUDA tensor
    launches the kernel, a CPU tensor runs gather_plain."""
    check_tensor("pool", pool, torch.float32, (None, COLS))
    check_tensor("idx", idx, torch.int32, (None, 1), pool.device)
    if not pool.is_cuda:
        return gather_plain(pool, idx, iters, onehot)
    n = idx.shape[0]
    out = torch.empty((n, COLS), dtype=torch.float32, device=pool.device)
    launch(_kernel_lib(), "hydra_lab_gather", "gather", pool.device,
           pool.data_ptr(), idx.data_ptr(), out.data_ptr(), n, pool.shape[0],
           iters, int(onehot))
    global gather_launches, onehot_launches
    if onehot:
        onehot_launches += 1
    else:
        gather_launches += 1
    return out


def gather_bound_ms(n: int, s: int) -> tuple[float, str]:
    """idx read once, the pool once, out written once; one add per gathered
    float (the bf16 rounding is not counted)."""
    return bound_ms(n * 4 + s * COLS * 4 + n * COLS * 4, n * ITERS * COLS)


def inputs(r: int = R, s: int = S, seed: int = 0, device="cuda"):
    """The tool's inputs: pool (s, 128) normal, idx (r, 1) uniform in [0, s)."""
    rng = np.random.default_rng(seed)
    pool = torch.tensor(rng.normal(size=(s, COLS)).astype(np.float32))
    idx = torch.tensor(rng.integers(0, s, (r, 1)).astype(np.int32))
    return pool.to(device), idx.to(device)


def main(variant: str = "all", device="cuda", r: int = R, s: int = S,
         n: int = 5) -> dict:
    """Time the chosen kernels on the tool's inputs; returns {variant:
    {"ms", "bound_ms", "bound_by"}}. On the CPU the plain versions run."""
    dev = resolve_device(device)
    names = list(VARIANTS) if variant == "all" else [variant]
    if any(v not in VARIANTS for v in names):
        raise ValueError(f"variant must be one of {list(VARIANTS)} or 'all'")
    pool, idx = inputs(r, s, device=dev)
    label = device_label(dev)
    bms, by = gather_bound_ms(r, s)
    out = {}
    for name in names:
        onehot = VARIANTS[name]
        ms = time_ms(lambda: gather(pool, idx, onehot=onehot), n, dev,
                     graph=True)
        rows = r * ITERS
        print(f"{name:6s}: {ms:.4f} ms -> {rows / ms / 1e6:.2f} Grows/s "
              f"({ms * 1e6 / rows:.4f} ns/row), bound {bms:.4f} ms ({by}) "
              f"[{label}]", flush=True)
        out[name] = {"ms": ms, "bound_ms": bms, "bound_by": by}
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
