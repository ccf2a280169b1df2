"""Golden-image gate for the port: the five procedural goldens of
tests/golden_scenes.py, rendered by the PyTorch port on the CPU (plain
twins of the kernels) at 64x64, 64 spp, seed 777, must reach MSE < 50 on
the 0..255 LDR scale against the committed tests/golden/*.npz — the gate
tests/test_golden.py holds the JAX package to."""
import os

import numpy as np
import pytest
import torch

import tests.golden_scenes as gs
from hydracore_tpu_torch.integrators.pt import render
from hydracore_tpu_torch.scene.procedural import SceneBuilder as PortBuilder
from tests.test_torch_scene import build_with

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)

GOLD_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("name", sorted(gs.SCENES))
def test_port_golden_mse(name):
    ref = np.load(os.path.join(GOLD_DIR, f"{name}.npz"))["ldr"].astype(np.float32)
    sc = build_with(PortBuilder, gs.SCENES[name])
    img = render(sc, spp=gs.SPP, seed=gs.SEED, device="cpu").numpy()
    mse = float(np.mean((gs.hdr_to_ldr255(img) - ref) ** 2))
    assert mse < 50.0, f"{name}: MSE {mse:.2f} vs golden"
