"""Kernel lab T6: ten small primitive probes on the card.

Port of tools/proto_prims.py, which probed the scalar and vector primitives
the packet traversal kernel needed on the TPU. Each probe k1 ... k10 reads
x (64, 128) f32 (k4 also xi (64, 128) i32) and writes one row (1, 128)
f32; csrc/lab_prims.cu lists what each computes. prim() launches the
probe's kernel on a CUDA tensor and runs prim_plain on a CPU tensor; it
counts launches in prim_launches. The probes run from main(), never at
import.

    python -m hydracore_tpu_torch.tools.proto_prims [k1 ... k10|all]

prints, as the tool does, OK and the first four values of each probe's row
(FAIL where it disagrees with its plain version), with its time per launch
and its bound, beside the card's name and power limit. A time is the mean
of GRAPH_CALLS launches replayed from a CUDA graph (so without the host's
time to issue them); the graph is replayed REPS times: the median and the
spread. The
launch floor, empty()'s kernel over a graph of the same length, is timed
first and printed beside every probe: launch latency, not the bytes bound,
sets these times.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from hydracore_tpu_torch.utils.build import CI, VP, launch, load_lib
from hydracore_tpu_torch.utils.device import resolve_device
from hydracore_tpu_torch.utils.lab import (bound_ms, check_tensor,
                                           device_label, time_ms)

SHAPE = (64, 128)
NAMES = {
    1: "scalar read VMEM dyn idx",
    2: "reduce->scalar for pl.ds",
    3: "vector extract static idx",
    4: "int scalar read -> pl.ds",
    5: "reshape (1,128)->(8,16)",
    6: "SMEM dyn write/read",
    7: "while + SMEM stack",
    8: "lane reduce (8,128)->(8,1)",
    9: "bitcast 2D f32->i32",
    10: "strided lane slice",
}

# every time of T6 (probe, library call, floor) is over a CUDA graph of
# this many calls; main() replays each probe's one graph REPS times, as
# the first port's tool captured one graph a probe
GRAPH_CALLS = 1000
REPS = 3

prim_launches = 0

_lib = None


def reset_launch_counts() -> None:
    global prim_launches
    prim_launches = 0


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = load_lib("lab_prims.cu", "hydra_lab_prim", [CI, VP, VP, VP, VP])
        _lib.hydra_lab_empty.argtypes = [VP]
        _lib.hydra_lab_empty.restype = CI
    return _lib


def _row(v, x):
    """(1, 128) f32 row of v, a 0-d tensor or a number."""
    v = torch.as_tensor(v, dtype=torch.float32, device=x.device)
    return v.reshape(1, 1).expand(1, SHAPE[1]).clone()


def _sum_in_order(vals):
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v
    return acc


def prim_plain(k: int, x, xi):
    """Probe k of x (64, 128) f32 and xi (64, 128) i32 in plain PyTorch."""
    if k == 1:
        return _row(x[3, 5], x)
    if k == 2:
        s = int(x[0, :8].to(torch.int32).sum())
        s = (s + 2**31) % 2**32 - 2**31  # the int32 sum wraps around
        s %= 60
        return x[s:s + 1].clone()
    if k == 3:
        return _row(_sum_in_order(list(x[3, :8])), x)
    if k == 4:
        i = int(xi[0, 2]) % 60
        return x[i:i + 1].clone()
    if k == 5:
        return _row(_sum_in_order(list(x[2].reshape(8, 16)[:, 0])), x)
    if k == 6:
        i = 7 * 8 % 60
        return x[i:i + 1].clone()
    if k == 7:
        stack = [5, 2, 3, 4, 1]
        return _row(float(sum(reversed(stack))), x)
    if k == 8:
        return _row(_sum_in_order(list(x[0:8].amax(dim=1))), x) + 0.0
    if k == 9:
        return x[0:1].view(torch.int32).to(torch.float32)
    if k == 10:
        out = torch.zeros((1, SHAPE[1]), dtype=torch.float32, device=x.device)
        out[0, :8] = x[0, 0:128:16]
        return out
    raise ValueError(f"no probe k{k}: 1 ... 10")


def prim(k: int, x, xi):
    """Probe k (1 ... 10): a CUDA tensor launches its kernel, a CPU tensor
    runs prim_plain."""
    check_tensor("x", x, torch.float32, SHAPE)
    check_tensor("xi", xi, torch.int32, SHAPE, x.device)
    if k not in NAMES:
        raise ValueError(f"no probe k{k}: 1 ... 10")
    if not x.is_cuda:
        return prim_plain(k, x, xi)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (k8's float4 loads)")
    out = torch.empty((1, SHAPE[1]), dtype=torch.float32, device=x.device)
    launch(_kernel_lib(), "hydra_lab_prim", f"probe k{k}", x.device, k,
           x.data_ptr(), xi.data_ptr(), out.data_ptr())
    global prim_launches
    prim_launches += 1
    return out


def empty(device="cuda") -> None:
    """One launch of the empty kernel (one CTA of 128 threads, no work) on
    `device`'s current stream: the launch floor that the probes' times
    stand beside. Counted nowhere: it replaces no TPU kernel."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the launch floor exists only on the card")
    launch(_kernel_lib(), "hydra_lab_empty", "empty", dev)


def inputs(device="cuda"):
    """The tool's x and xi: arange(64 * 128) as f32 and as i32."""
    x = torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.float32).reshape(SHAPE)
    xi = torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.int32).reshape(SHAPE)
    return x.to(device), xi.to(device)


def adversarial_inputs(device="cuda") -> dict:
    """k8's hard cases, name -> (x, xi): x a seeded normal draw, xi the
    tool's, and
      nan       x[2, 77] NaN: the row maxima, and the sum, are NaN;
      neg_inf   row 5 all -inf: its maximum is -inf, and the sum;
      zero_tie  rows 0:8 negative but for a -0.0 and a +0.0 (in either
                order), so every row's maximum is a tie of the two zeros
                and the sum of the maxima is a zero;
      zero_row  the same tie in row 4 only, beside nonzero maxima."""
    rng = np.random.default_rng(16)
    base = rng.normal(size=SHAPE).astype(np.float32)
    cases = {k: base.copy() for k in ("nan", "neg_inf", "zero_tie",
                                      "zero_row")}
    cases["nan"][2, 77] = np.nan
    cases["neg_inf"][5] = -np.inf
    for r in range(8):
        x = cases["zero_tie"]
        x[r] = -np.abs(x[r]) - 0.5
        x[r, 10], x[r, 100] = (-0.0, 0.0) if r % 2 else (0.0, -0.0)
    x = cases["zero_row"]
    x[4] = -np.abs(x[4]) - 0.5
    x[4, 10], x[4, 100] = -0.0, 0.0
    _, xi = inputs(device)
    return {k: (torch.tensor(v).to(device), xi) for k, v in cases.items()}


# what each probe needs of its inputs: (bytes read, operations done once),
# e.g. k2 reads x[0, :8] and then one row of x, and converts, adds and takes
# a modulo; k7 reads nothing and adds the four popped entries
NEEDS = {1: (4, 0), 2: (32 + 512, 16), 3: (32, 7), 4: (4 + 512, 1),
         5: (32, 7), 6: (512, 2), 7: (0, 4), 8: (8 * 512, 8 * 127 + 7),
         9: (512, 128), 10: (32, 0)}


def prim_bound_ms(k: int) -> tuple[float, str]:
    """The bytes probe k reads and its 512-byte row out, and the operations
    it does (NEEDS): a few nanoseconds, far below a launch."""
    n_bytes, n_ops = NEEDS[k]
    return bound_ms(n_bytes + SHAPE[1] * 4, n_ops)


def main(variant: str = "all", device="cuda", n: int = GRAPH_CALLS) -> dict:
    """Time the launch floor (empty()), then run each chosen probe, check
    it against its plain version, and time it; each time over n launches (a
    CUDA graph on the card), REPS times. Returns {"floor": {"ms", "spread"},
    "k1": {"ms", "spread", "ok", "bound_ms", "bound_by"}, ...}: ms the
    median, spread (min, max) of the REPS times."""
    dev = resolve_device(device)
    ks = list(NAMES) if variant == "all" else [int(variant.lstrip("k"))]
    x, xi = inputs(dev)
    label = device_label(dev)
    out = {}

    def median_spread(fn):
        ts = time_ms(fn, n, dev, graph=True, reps=REPS)
        return float(np.median(ts)), (min(ts), max(ts))

    if dev.type == "cuda":
        floor, spread = median_spread(lambda: empty(dev))
        out["floor"] = {"ms": floor, "spread": spread}
        print(f"launch floor (empty kernel): {floor * 1e3:.3f} us/launch "
              f"({spread[0] * 1e3:.3f}-{spread[1] * 1e3:.3f}) [{label}]",
              flush=True)
    for k in ks:
        r = prim(k, x, xi)
        ok = torch.equal(r.cpu(), prim_plain(k, x.cpu(), xi.cpu()))
        ms, spread = median_spread(lambda: prim(k, x, xi))
        bms, by = prim_bound_ms(k)
        vals = r[0, :4].cpu().numpy()
        floor = (f", {ms / out['floor']['ms']:.2f}x the floor"
                 if "floor" in out else "")
        print(f"{'OK  ' if ok else 'FAIL'} {NAMES[k]}: {vals} "
              f"{ms * 1e3:.3f} us/launch ({spread[0] * 1e3:.3f}-"
              f"{spread[1] * 1e3:.3f}){floor}, bound {bms * 1e6:.3f} ns "
              f"({by}) [{label}]", flush=True)
        out[f"k{k}"] = {"ms": ms, "spread": spread, "ok": ok, "bound_ms": bms,
                        "bound_by": by}
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
