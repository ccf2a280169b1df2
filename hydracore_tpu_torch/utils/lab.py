"""What the kernel lab's tools (hydracore_tpu_torch/tools/) and
chip_smoke.py share: the card's peak rates and the bound they give,
input checks, timing (alone and in turns), and the label that every
printed time stands beside.

Times on the card come from CUDA events; on the CPU the tools run the
plain versions, timed on the host's clock and labelled as such, never as a
device number.
"""
from __future__ import annotations

import subprocess
import statistics
import time

import torch

# NVIDIA H100 SXM data sheet: HBM rate and f32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the f32 operations over the f32 rate, and which."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_tensor(name: str, x: torch.Tensor, dtype, shape=None,
                 device=None) -> None:
    """Raise unless x has `dtype`, `shape` (None entries match any size),
    lies on `device` and, on the card, is contiguous."""
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if shape is not None and (x.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, x.shape))):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if device is not None and x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.is_cuda and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_label(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or a label
    that says the numbers are the CPU's plain versions."""
    if torch.device(device).type != "cuda":
        return "cpu, plain PyTorch versions, host clock"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int, device, graph: bool = False, result: bool = False,
            reps: int = 1):
    """Mean time of one fn() over n calls, after one warm-up call. On the
    card: CUDA events around n back-to-back calls, or with `graph` around
    the replay of a CUDA graph that holds n calls, so that the host's time
    to issue a call is not in it (fn must then not synchronize; the graph is
    captured once, so a wrapper's launch counter sees n + 1 calls however
    often it is replayed). On the CPU: the host clock. With reps > 1 the n
    calls (the one graph) run reps times, each timed, and the list of the
    reps means comes back. With `result`, returns (ms, what the warm-up
    call returned)."""
    res = fn()
    on_card = torch.device(device).type == "cuda"

    def calls():
        for _ in range(n):
            fn()

    run = calls
    if on_card and graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            calls()
        g.replay()
        run = g.replay
    out = []
    for _ in range(reps):
        if not on_card:
            t0 = time.perf_counter()
            run()
            out.append((time.perf_counter() - t0) * 1e3 / n)
            continue
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / n)
    ms = out[0] if reps == 1 else out
    return (ms, res) if result else ms


def interleaved(fns: dict, n: int, device, reps: int = 4) -> dict:
    """Each fn timed as a CUDA graph of n calls, reps times, in turns
    (forward, then backward: A B C C B A ...), so that a drift of the card
    over the run falls on all alike; name -> (median ms, (min, max))."""
    ts = {name: [] for name in fns}
    names = list(fns)
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            ts[name].append(time_ms(fns[name], n, device, graph=True))
    return {name: (statistics.median(v), (min(v), max(v)))
            for name, v in ts.items()}
