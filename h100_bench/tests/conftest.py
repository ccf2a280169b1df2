"""Shared fixtures of the benchmark's tests: small runs of a cell on the
CPU (the port's plain versions), and the card for card-only tests."""
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a size a test run holds: 16x16, tiles of 64 pixels at 8 samples, LT
# passes of 4,096 paths; every shape of the cell kept but the frame's
SMALL = {"config": {"width": 16, "height": 16},
         "traffic": {"tile_pixels": 64, "k_samples": 8,
                     "paths_per_step": 4096, "tile_stride": 2,
                     "check": {"tiles": 3, "pixels": 24, "passes": 2,
                               "early": 3}}}
SEED = 2**31 + 4242


def small_run(cell: str, seed: int = SEED, trace: bool = False,
              seconds: float = 0.4, control=None, min_steps: int = 1) -> dict:
    from h100_bench import harness

    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), overrides=SMALL,
                            control=control, min_steps=min_steps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return torch.device("cuda")
