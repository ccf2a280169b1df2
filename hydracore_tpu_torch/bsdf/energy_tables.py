"""Multiscatter energy tables: the baked GGX directional albedo E(alpha, mu)
(64x64) and the rough-dielectric albedo E(ior, alpha, mu) (64^3).

Shading applies Kulla-Conty style energy compensation from them, as the
reference's GetMultiscatteringFrom2dTable / 3dTable do. The loaders read
the committed .npz tables; the bakers (the reference's offline
bakeBrdfEnergy/ -> MSTablesGGX2017.cpp and MSTablesTransp.cpp) are the JAX
package's numpy Monte-Carlo bakes, with the same seeded generator and the
same operations in the same order, so they reproduce its tables bit for
bit. The committed tables are what shading reads; a bake is never written
over them.
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


# ----------------------------------------------------------------------------
# The bakers (numpy, seeded): E(alpha, mu) of single-scatter GGX and
# E(ior, alpha, mu) of the single-scatter Walter rough dielectric
# ----------------------------------------------------------------------------

_SIZE = 64
_SAMPLES = 2048


def _ggx_albedo(mu: float, alpha: float, n_samples: int, rng) -> float:
    """E = int f_ggx(wo, wi) cos dwi via NDF importance sampling."""
    wo = np.array([np.sqrt(max(1 - mu * mu, 0.0)), 0.0, mu])
    u1 = rng.random(n_samples)
    u2 = rng.random(n_samples)
    a2 = alpha * alpha
    ct2 = (1 - u1) / np.maximum(1 + (a2 - 1) * u1, 1e-12)
    ct = np.sqrt(np.clip(ct2, 0, 1))
    st = np.sqrt(np.clip(1 - ct2, 0, 1))
    phi = 2 * np.pi * u2
    h = np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1)
    woh = h @ wo
    wi = 2 * woh[:, None] * h - wo
    cos_i = wi[:, 2]
    valid = (cos_i > 0) & (woh > 0)

    def g1(c):
        c = np.maximum(c, 1e-6)
        return 2 * c / (c + np.sqrt(a2 + (1 - a2) * c * c))

    # weight for NDF sampling of reflection: G(wo,wi) * woh / (cos_o * cos_h)
    w = g1(mu) * g1(np.abs(cos_i)) * woh / np.maximum(mu * ct, 1e-9)
    return float(np.where(valid, w, 0.0).mean())


def bake_ggx_albedo(size: int = _SIZE, n_samples: int = _SAMPLES,
                    seed: int = 1) -> np.ndarray:
    """(size, size) float32 E, rows alpha, columns mu."""
    rng = np.random.default_rng(seed)
    E = np.zeros((size, size), np.float32)
    for i in range(size):
        alpha = max((i + 0.5) / size, 1e-3)
        for j in range(size):
            mu = max((j + 0.5) / size, 1e-3)
            E[i, j] = _ggx_albedo(mu, alpha, n_samples, rng)
    return np.clip(E, 0.0, 1.0)


def _transp_albedo_row(mu_grid: np.ndarray, alpha: float, eta: float,
                       n_samples: int, rng) -> np.ndarray:
    """Directional albedo of the single-scatter Walter rough dielectric
    (reflection + refraction, Fresnel split, Smith G2/G1 energy estimator,
    the estimator the reference glass sampler applies as Pss,
    cmaterial.h:836-841) for every mu in mu_grid at once."""
    M = mu_grid.shape[0]
    mu = mu_grid[:, None]
    sin_o = np.sqrt(np.clip(1.0 - mu * mu, 0.0, 1.0))
    a2 = alpha * alpha
    u1 = rng.random((M, n_samples))
    u2 = rng.random((M, n_samples))
    ct2 = (1.0 - u1) / np.maximum(1.0 + (a2 - 1.0) * u1, 1e-12)
    ct = np.sqrt(np.clip(ct2, 0.0, 1.0))
    st = np.sqrt(np.clip(1.0 - ct2, 0.0, 1.0))
    phi = 2.0 * np.pi * u2
    hx, hy, hz = st * np.cos(phi), st * np.sin(phi), ct
    # wo = (sin_o, 0, mu)
    woh = sin_o * hx + mu * hz
    valid_h = woh > 1e-9

    def g1(c):
        c = np.maximum(np.abs(c), 1e-6)
        return 2.0 * c / (c + np.sqrt(a2 + (1.0 - a2) * c * c))

    # Fresnel for relative ior eta = n_t/n_i seen from the wo side
    ci = np.clip(woh, 0.0, 1.0)
    sin2_t = np.maximum(0.0, 1.0 - ci * ci) / max(eta * eta, 1e-12)
    tir = sin2_t >= 1.0
    cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 0.0))
    r_par = (eta * ci - cos_t) / np.maximum(eta * ci + cos_t, 1e-12)
    r_perp = (ci - eta * cos_t) / np.maximum(ci + eta * cos_t, 1e-12)
    F = np.where(tir, 1.0, np.clip(0.5 * (r_par ** 2 + r_perp ** 2), 0.0, 1.0))

    # reflection branch: wi = 2(wo.h)h - wo
    wiz_r = 2.0 * woh * hz - mu
    w_common = woh / np.maximum(mu * ct, 1e-9)  # woh/(cos_o cos_h)
    w_refl = np.where((wiz_r > 0) & valid_h,
                      g1(mu) * g1(wiz_r) * w_common, 0.0)
    # refraction branch (Snell about h); the estimator has the same form:
    # the half-vector jacobians cancel (Walter 2007 eq. 17/21)
    inv_eta = 1.0 / max(eta, 1e-9)
    wiz_t = (inv_eta * ci - cos_t) * hz - inv_eta * mu
    w_refr = np.where((wiz_t < 0) & valid_h & ~tir,
                      g1(mu) * g1(wiz_t) * w_common, 0.0)
    E = (F * w_refl + (1.0 - F) * w_refr).mean(axis=1)
    return np.clip(E, 0.0, 1.5)  # G2/G1 estimator can exceed 1 slightly


def bake_transp_albedo(size: int = _SIZE, n_samples: int = 512,
                       seed: int = 7) -> np.ndarray:
    """E[z=ior, y=alpha, x=mu]: the axis order of the reference lookup
    (x=dotNV, y=roughness, z=normalized ior over [TRANSP_IOR_MIN,
    TRANSP_IOR_MAX])."""
    rng = np.random.default_rng(seed)
    mu_grid = np.maximum((np.arange(size) + 0.5) / size, 1e-3)
    E = np.zeros((size, size, size), np.float32)
    for k in range(size):
        ior = TRANSP_IOR_MIN + (k + 0.5) / size * (TRANSP_IOR_MAX - TRANSP_IOR_MIN)
        for i in range(size):
            alpha = max((i + 0.5) / size, 1e-3)
            E[k, i] = _transp_albedo_row(mu_grid, alpha, ior, n_samples, rng)
    return np.clip(E, 1e-4, 1.0)


def multiscatter_factor(E_table, mu, alpha):
    """Kulla-Conty energy compensation multiplier 1 + (1-E)/E applied to
    the single-scatter lobe, as a table lookup on E_table's device."""
    E_table = torch.as_tensor(E_table)
    size = E_table.shape[0]
    mu = torch.as_tensor(mu, device=E_table.device)
    alpha = torch.as_tensor(alpha, device=E_table.device)
    i = torch.clamp((alpha * size).to(torch.int32), 0, size - 1).long()
    j = torch.clamp((mu * size).to(torch.int32), 0, size - 1).long()
    E = E_table[i, j]
    return 1.0 + (1.0 - E) / torch.clamp(E, min=0.05)
