"""Kernel lab T7: throughput of random row gathers on the card.

Port of tools/bench_pallas_gather.py, which asked whether per-ray row
gathers from an on-chip node pool are fast enough for a per-ray traversal.
For a pool (S, 128) f32 and indices idx (R, 1) i32 both of its kernels
compute

    out[r] = 0 + sum over it < ITERS of term((idx[r] + it) % S)

in iteration order, idx[r] + it wrapping as int32 arithmetic does and %
the floor modulo. The "taa" kernel's term is the pool's row; the "onehot"
kernel's is what its one-hot bf16 matmul with f32 accumulation gives: the
row rounded to bf16, except that a column is NaN where another row holds an
inf or a NaN in it (the product adds 0 * inf). gather_plain says it exactly.

gather() launches csrc/lab_gather.cu on a CUDA tensor and runs gather_plain
on a CPU tensor. On the card it picks, from the shapes alone
(uses_window), the window path (the S window sums W[j] first, then
out[r] = W[idx[r] % S]; a row whose index wraps sums directly) or the
direct kernel (ITERS row reads a row); gather_direct() always takes the
direct kernel, the tool's own question. Launches are counted in
`launches`, by variant and path.

    python -m hydracore_tpu_torch.tools.bench_pallas_gather [taa|onehot|all|sweep]

prints, for each kernel, its time at the tool's size (S 4096, R 262,144,
16 iterations; on the card the mean of n calls replayed from a CUDA graph)
through gather() and through the direct kernel, the function's row sums per
second beside the rows each path reads, and the card's name and power
limit. `sweep` times both paths in turns beside a plain write of the
output, each kernel's device time, and both paths over the grid of
(iters, S) that uses_window's rule was read from.
"""
from __future__ import annotations

import re
import sys

import numpy as np
import torch

from hydracore_tpu_torch.utils.build import CI, VP, launch, load_lib
from hydracore_tpu_torch.utils.device import resolve_device
from hydracore_tpu_torch.utils.lab import (bound_ms, check_tensor,
                                           device_label, interleaved,
                                           time_ms)

S = 4096       # pool rows (node pool)
R = 262144     # total rays
ITERS = 16     # gathers per ray
COLS = 128

VARIANTS = {"taa": False, "onehot": True}
PATHS = ("window", "direct")
INT32_MAX = 2**31 - 1

# the window pass stages kTile + iters - 1 rows in 48 KiB of shared memory
MAX_WINDOW_ITERS = 65

# kernel launches by (variant, path)
launches = {(v, p): 0 for v in VARIANTS for p in PATHS}

_lib = None


def reset_launch_counts() -> None:
    for key in launches:
        launches[key] = 0


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = load_lib("lab_gather.cu", "hydra_lab_gather",
                        [VP, VP, VP, VP, VP, CI, CI, CI, CI, VP])
    return _lib


def wrap_above(s: int, iters: int) -> int:
    """idx + it wraps (for some it < iters) only for idx above this; where
    s divides 2^32 the wrap leaves every row mod s as it is."""
    if iters >= 1 and s & (s - 1):
        return INT32_MAX - (iters - 1)
    return INT32_MAX


def wrapping_rows(idx, s: int, iters: int = ITERS) -> int:
    """The rows that the window path sums directly."""
    return int((idx.reshape(-1).to(torch.int64) > wrap_above(s, iters)).sum())


def uses_window(n: int, s: int, iters: int = ITERS) -> bool:
    """The window path where it moves fewer rows than the direct kernel
    reads: s pool rows read (a CTA's windows share their rows in shared
    memory) and s rows of W written, then n read, against n * iters rows
    read at random; and where its shared memory holds the rows (iters <=
    MAX_WINDOW_ITERS). On the H100 this picks taa's faster path at every
    (iters, S) that `sweep` times."""
    return iters <= MAX_WINDOW_ITERS and 2 * s + n < n * iters


def rows_read(n: int, s: int, iters: int = ITERS, window: bool = True,
              wrapping: int = 0) -> int:
    """The pool and window rows a path reads (idx and stats aside)."""
    if not window:
        return n * iters
    return s * iters + (n - wrapping) + wrapping * iters


def column_stats(b):
    """For each column of b: how many values are inf or NaN, and the row of
    the first of them (0 where there is none)."""
    bad = ~torch.isfinite(b)
    return bad.sum(0), bad.to(torch.int32).argmax(0)


def gather_plain(pool, idx, iters: int = ITERS, onehot: bool = False):
    """The gather-sum in plain PyTorch, summed in iteration order: idx + it
    wraps as int32 does, then the floor modulo S. onehot takes bf16(pool)
    and, column by column, a NaN term where a row other than the gathered
    one holds an inf or a NaN."""
    s = pool.shape[0]
    rows = pool.to(torch.bfloat16).to(torch.float32) if onehot else pool
    if onehot:
        count, first = column_stats(rows)
    i0 = idx.reshape(-1).to(torch.int64)
    acc = torch.zeros((i0.numel(), pool.shape[1]), dtype=torch.float32,
                      device=pool.device)
    for it in range(iters):
        k = ((i0 + it + 2**31) % 2**32 - 2**31) % s
        term = rows[k]
        if onehot:
            nan = (count >= 2) | ((count == 1) & (first != k[:, None]))
            term = torch.where(nan, float("nan"), term)
        acc = acc + term
    return acc


def _check(pool, idx):
    check_tensor("pool", pool, torch.float32, (None, COLS))
    check_tensor("idx", idx, torch.int32, (None, 1), pool.device)


def _launch(pool, idx, iters: int, onehot: bool, window: bool):
    n, s = idx.shape[0], pool.shape[0]
    out = torch.empty((n, COLS), dtype=torch.float32, device=pool.device)
    if n == 0:
        return out
    win = (torch.empty((s, COLS), dtype=torch.float32, device=pool.device)
           if window else None)
    stats = (torch.empty(2 * COLS, dtype=torch.int32, device=pool.device)
             if onehot else None)
    launch(_kernel_lib(), "hydra_lab_gather", "gather", pool.device,
           pool.data_ptr(), idx.data_ptr(), out.data_ptr(),
           None if win is None else win.data_ptr(),
           None if stats is None else stats.data_ptr(), n, s, iters,
           int(onehot))
    launches[("onehot" if onehot else "taa",
              "window" if window else "direct")] += 1
    return out


def gather(pool, idx, iters: int = ITERS, onehot: bool = False):
    """pool (S, 128) f32, idx (R, 1) i32 -> (R, 128) f32. A CUDA tensor
    launches the kernels of the path that the shapes choose (the window
    sums are rebuilt in every call), a CPU tensor runs gather_plain."""
    _check(pool, idx)
    if not pool.is_cuda:
        return gather_plain(pool, idx, iters, onehot)
    return _launch(pool, idx, iters, onehot,
                   uses_window(idx.shape[0], pool.shape[0], iters))


def gather_direct(pool, idx, iters: int = ITERS, onehot: bool = False):
    """gather() through the direct kernel whatever the shapes: iters random
    row reads an output row."""
    _check(pool, idx)
    if not pool.is_cuda:
        return gather_plain(pool, idx, iters, onehot)
    return _launch(pool, idx, iters, onehot, False)


def same_bits(a, b) -> bool:
    """a and b equal bit for bit, any NaN matching any NaN."""
    if a.shape != b.shape:
        return False
    ab = a.contiguous().view(torch.int32)
    bb = b.contiguous().view(torch.int32)
    return bool(((ab == bb) | (torch.isnan(a) & torch.isnan(b))).all())


def gather_bound_ms(n: int, s: int, iters: int = ITERS) -> tuple[float, str]:
    """idx read once, the pool once, out written once; one add per gathered
    float (the bf16 rounding is not counted)."""
    return bound_ms(n * 4 + s * COLS * 4 + n * COLS * 4, n * iters * COLS)


def inputs(r: int = R, s: int = S, seed: int = 0, device="cuda"):
    """The tool's inputs: pool (s, 128) normal, idx (r, 1) uniform in [0, s)."""
    rng = np.random.default_rng(seed)
    pool = torch.tensor(rng.normal(size=(s, COLS)).astype(np.float32))
    idx = torch.tensor(rng.integers(0, s, (r, 1)).astype(np.int32))
    return pool.to(device), idx.to(device)


def _hard_pool(s: int, rng) -> np.ndarray:
    """A normal draw (s >= 64) with non-finite values, signed zeros, bf16
    ties, subnormals and columns whose sums overflow."""
    p = rng.normal(size=(s, COLS)).astype(np.float32)
    p[5, 3], p[7, 4], p[11, 6] = np.inf, np.nan, -np.inf
    p[9, 5] = 3.4e38                      # finite, bf16 rounds it to inf
    p[40, 9], p[41, 9] = np.inf, -np.inf  # two non-finite in a column
    p[13, 10] = p[14, 10] = np.nan
    p[15, 11] = -0.0
    p[:, 12] = -0.0
    # bf16 ties (to even: down, up), either sign, and a value past one
    ties = np.array([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), -(1 + 3 * 2**-8),
                     3 + 2**-7, 1 + 2**-8 + 2**-20], np.float32)
    p[16:64, 13] = np.resize(ties, 48)
    # subnormals, the least of either sign among them; then the overflows
    sub = np.array([1e-40, -3e-39, 1.4e-45, -1.4e-45, 5.9e-39, 1.1e-38],
                   np.float32)
    p[:64, 14] = np.resize(sub, 64)
    p[20:36, 15] = 3e38
    p[20:36, 16] = -2e38
    return p


def _hard_idx(r: int, s: int, rng) -> np.ndarray:
    """r indices: the hard ones first and last (negative, >= s, the int32
    ends, the rows just under 2^31 whose idx + it wraps), windows over the
    first rows of the pool, and uniform draws in [0, s) and over int32."""
    hard = [-1, -2, -17, -s + 1, -s, -s - 1, -123456789, s - 1, s, s + 1,
            2 * s + 3, 123456789, -2**31, -2**31 + 1, 2**31 - 1, 2**31 - 2,
            2**31 - 9, 2**31 - 15, 2**31 - 16, 2**31 - 17]
    hard += list(range(-20, 48))
    idx = np.concatenate([rng.integers(0, s, r // 2),
                          rng.integers(-2**31, 2**31, r - r // 2)])
    rng.shuffle(idx)
    idx[:len(hard)] = hard
    idx[-len(hard):] = hard
    return idx.astype(np.int32).reshape(r, 1)


ADVERSARIAL = ("wrap_3000", "wrap_4096", "nonfinite", "iters1", "iters0",
               "small_pool", "direct")


def adversarial_inputs(device="cuda") -> dict:
    """T7's hard cases, name -> (pool, idx, iters), each with the hard
    indices of _hard_idx in its first and last rows; R is a multiple of no
    warp or CTA size:
      wrap_3000   S 3000, a normal pool: rows just under 2^31 wrap and land
                  elsewhere mod S than their window (the window path's
                  direct rows);
      wrap_4096   the same at S 4096, which divides 2^32: no row differs;
      nonfinite   _hard_pool at S 3000: inf, NaN, 3.4e38, -0.0, bf16 ties,
                  subnormals, sums that overflow;
      iters1      the same pool, 1 iteration (the direct kernel; onehot's
                  term of the one non-finite row itself);
      iters0      the same pool, no iteration: zeros;
      small_pool  S 5 < 16 iterations, an inf and a subnormal;
      direct      _hard_pool at S 8192 > R: the direct kernel."""
    rng = np.random.default_rng(19)
    hard = _hard_pool(3000, rng)
    small = rng.normal(size=(5, COLS)).astype(np.float32)
    small[2, 3], small[1, 14], small[3, 12] = np.inf, 1e-40, -0.0
    cases = {
        "wrap_3000": (rng.normal(size=(3000, COLS)).astype(np.float32),
                      _hard_idx(5003, 3000, rng), ITERS),
        "wrap_4096": (rng.normal(size=(4096, COLS)).astype(np.float32),
                      _hard_idx(5003, 4096, rng), ITERS),
        "nonfinite": (hard, _hard_idx(5003, 3000, rng), ITERS),
        "iters1": (hard, _hard_idx(5003, 3000, rng), 1),
        "iters0": (hard, _hard_idx(1001, 3000, rng), 0),
        "small_pool": (small, _hard_idx(5003, 5, rng), ITERS),
        "direct": (_hard_pool(8192, rng), _hard_idx(517, 8192, rng), ITERS),
    }
    return {k: (torch.tensor(cases[k][0]).to(device),
                torch.tensor(cases[k][1]).to(device), cases[k][2])
            for k in ADVERSARIAL}


def main(variant: str = "all", device="cuda", r: int = R, s: int = S,
         n: int = 5) -> dict:
    """Time the chosen kernels on the tool's inputs through gather() (key
    the variant) and through the direct kernel (key "<variant> direct");
    returns {key: {"ms", "path", "rows_read", "bound_ms", "bound_by"}}. On
    the CPU the plain versions run."""
    dev = resolve_device(device)
    names = list(VARIANTS) if variant == "all" else [variant]
    if any(v not in VARIANTS for v in names):
        raise ValueError(f"variant must be one of {list(VARIANTS)} or 'all'")
    pool, idx = inputs(r, s, device=dev)
    label = device_label(dev)
    bms, by = gather_bound_ms(r, s)
    sums = r * ITERS
    out = {}
    for name in names:
        onehot = VARIANTS[name]
        for key, fn in ((name, gather), (f"{name} direct", gather_direct)):
            path = ("window" if fn is gather and uses_window(r, s)
                    else "direct")
            ms = time_ms(lambda: fn(pool, idx, onehot=onehot), n, dev,
                         graph=True)
            read = rows_read(r, s, window=path == "window",
                             wrapping=wrapping_rows(idx, s))
            print(f"{key:13s} ({path} path): {ms:.4f} ms -> "
                  f"{sums / ms / 1e6:.2f} G row sums/s of the function's "
                  f"{sums} ({ms * 1e6 / sums:.4f} ns each); rows read "
                  f"{read} ({read / ms / 1e6:.2f} G rows/s); bound "
                  f"{bms:.4f} ms ({by}) [{label}]", flush=True)
            out[key] = {"ms": ms, "path": path, "rows_read": read,
                        "bound_ms": bms, "bound_by": by}
    return out


def kernel_split(fn, n: int = 5) -> dict:
    """torch.profiler over n calls of fn on the card: each kernel's (and
    memset's) device time a call in ms, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            m = re.search(r"\w+_kernel<[^>]*>", e.name())
            name = m.group(0) if m else e.name()
            split[name] = split.get(name, 0.0) + e.duration_ns() / 1e6 / n
    return split


def sweep(device="cuda", r: int = R, n: int = 5) -> dict:
    """On the card, in turns (utils/lab.py:interleaved): each variant at the
    tool's size through both paths, the window pass alone (R = 1) and a
    plain write of out (zero_(), the write rate the gather pass can reach),
    and each kernel's device time (kernel_split); then both paths over a
    grid of (iters, S), where uses_window's choice falls. Returns
    {(variant, what): median ms}."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("sweep times the kernels: it needs the card")
    label = device_label(dev)
    pool, idx = inputs(r, S, device=dev)
    buf = torch.empty((r, COLS), dtype=torch.float32, device=dev)
    out = {}

    def show(name, what, ms, spread):
        out[(name, what)] = ms
        print(f"sweep {name:6s} {what:28s}: {ms:.4f} ms ({spread[0]:.4f}-"
              f"{spread[1]:.4f}) [{label}]", flush=True)

    for name, onehot in VARIANTS.items():
        fns = {"window path": lambda: _launch(pool, idx, ITERS, onehot, True),
               "window pass alone (R = 1)": lambda: _launch(
                   pool, idx[:1], ITERS, onehot, True),
               "direct kernel": lambda: _launch(pool, idx, ITERS, onehot, False),
               "write of out (zero_)": buf.zero_}
        for what, (ms, spread) in interleaved(fns, n, dev).items():
            show(name, what, ms, spread)
        for window in (True, False):
            split = kernel_split(lambda: _launch(pool, idx, ITERS, onehot,
                                                 window))
            print(f"sweep {name:6s} kernels, {PATHS[not window]} path: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
                  + f" [{label}]", flush=True)
    del buf
    for iters, sizes in ((16, (r // 64, r // 16, r // 4, r, 2 * r, 4 * r,
                               8 * r)),
                         (4, (r // 2, r, 2 * r)), (2, (r // 4, r // 2, r))):
        for s in sizes:
            p, i = inputs(r, s, device=dev)
            for name, onehot in VARIANTS.items():
                fns = {path: (lambda w=path == "window": _launch(
                    p, i, iters, onehot, w)) for path in PATHS}
                pick = "window" if uses_window(r, s, iters) else "direct"
                for path, (ms, spread) in interleaved(fns, n, dev,
                                                      reps=2).items():
                    show(name, f"iters {iters} S {s} {path}"
                         f"{' (chosen)' if path == pick else ''}", ms, spread)
            del p, i
    return out


if __name__ == "__main__":
    arg = sys.argv[1] if len(sys.argv) > 1 else "all"
    if arg == "sweep":
        sweep()
    else:
        main(arg)
