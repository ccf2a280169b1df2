"""Multiscatter energy tables: the baked GGX directional albedo E(alpha, mu)
(64x64) and the rough-dielectric albedo E(ior, alpha, mu) (64^3).

Copies of the JAX package's committed .npz tables (bsdf/energy_tables.py
bakes them); shading applies Kulla-Conty style energy compensation from
them, as the reference's GetMultiscatteringFrom2dTable / 3dTable do.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
_GGX_PATH = os.path.join(_DIR, "ggx_albedo_64.npz")
_TRANSP_PATH = os.path.join(_DIR, "transp_albedo_64.npz")
TRANSP_IOR_MIN = 0.4166
TRANSP_IOR_MAX = 2.4


@lru_cache(maxsize=1)
def _ggx_np():
    E = np.load(_GGX_PATH)["E"].astype(np.float32)  # rows alpha, cols mu
    mu = (np.arange(E.shape[1]) + 0.5) / E.shape[1]
    e_avg = 2.0 * (E * mu[None, :]).mean(axis=1)  # int 2 mu E dmu
    return E, e_avg.astype(np.float32)


@lru_cache(maxsize=1)
def _transp_np():
    return np.load(_TRANSP_PATH)["E"].astype(np.float32)


@lru_cache(maxsize=8)
def ggx_tables(device: torch.device):
    """(E (64, 64), E_avg (64,)) on `device`."""
    E, e_avg = _ggx_np()
    return torch.tensor(E, device=device), torch.tensor(e_avg, device=device)


@lru_cache(maxsize=8)
def transp_table(device: torch.device):
    """E (64, 64, 64) indexed [ior, alpha, mu] on `device`."""
    return torch.tensor(_transp_np(), device=device)
