"""On the card: one short run of each cell through the command line, its
result line and exit code (skips without an NVIDIA GPU)."""
import json
import os
import subprocess
import sys

import pytest

from h100_bench import harness


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.benchmark()["workloads"]])
def test_a_short_run_is_correct_on_the_card(cuda, cell):
    r = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload",
                        cell, "--seed", str(2**31 + 5), "--seconds", "2",
                        "--trace", "0"], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=600, env=dict(os.environ))
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert r.stderr.strip().splitlines()[-1].startswith("check ")
