"""Run one cell of the benchmark once and print its result line.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero, and prints no result, without as many CUDA devices as the
cell asks for, or when the process loaded JAX or the JAX package. The last
lines on standard error, and the result line's last key "check", give each
number compared with its limit. `--control bf16` (not a benchmark run)
puts the reference, computed in bfloat16, in the port's place.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache of the run lives at a fixed path in the
# checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, os.path.join(ROOT, ".bench_cache", sub))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bf16",), default=None)
    a = p.parse_args(argv)

    import torch

    from h100_bench import harness

    marks = [("torch import", time.perf_counter())]
    chips = harness.cell(harness.benchmark(), a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100_bench: {a.workload} needs {chips} CUDA device(s); "
              f"this process sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)  # the CUDA context
    marks.append(("cuda context", time.perf_counter()))
    control = torch.bfloat16 if a.control == "bf16" else None
    out = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                           device, T_START, control=control, marks=marks)
    bad = harness.forbidden_modules()
    if bad:
        print(f"h100_bench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line, tail = harness.result_line(out)
    for t in tail:
        print(t, file=sys.stderr)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
