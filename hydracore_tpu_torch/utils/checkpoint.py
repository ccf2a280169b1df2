"""Render checkpoint/resume: durable accumulation state.

The same .npz layout as the JAX package's utils/checkpoint.py (keys
fb_sum, spp, seed, version), so a checkpoint written by either package
loads in the other: (HDR sum, spp, seed) round-trips through one file and
a render continues across process restarts,
`python -m hydracore_tpu_torch.app.cli ... -resume ckpt.npz`.
"""
from __future__ import annotations

import numpy as np


def save_checkpoint(path: str, fb_sum: np.ndarray, spp: int, seed: int):
    np.savez_compressed(
        path, fb_sum=np.asarray(fb_sum, np.float32),
        spp=np.int64(spp), seed=np.int64(seed), version=np.int64(1),
    )


def load_checkpoint(path: str):
    """Returns (fb_sum (H,W,3) float32, spp int, seed int)."""
    z = np.load(path)
    return z["fb_sum"].astype(np.float32), int(z["spp"]), int(z["seed"])
