"""PSSMLT — primary-sample-space Metropolis light transport, batched chains
(torch).

The JAX package's integrators/mlt.py (ref GPUOCLLayerAdvanced.cpp
MMLT_Pass:395 / mlt.cl): R Markov chains run in parallel, each holding a
primary-sample vector u in [0, 1)^D that drives the pixel position, the
lens and every per-bounce BSDF / NEE / RR / alpha decision of the path
tracer (pt.pt_trace in its legacy mode, the rays in chain order);
  * proposals: a large step (fresh uniforms, probability P_LARGE) or a
    Kelemen small step (exponential-scale offsets, wrapped onto [0, 1));
  * both the current and the proposed state splat with Veach's weights
    (1 - a) and a (MMLTAcceptReject, mlt.cl:205);
  * the burn-in picks the starting states in proportion to their
    contribution (systematic resampling on the host in float64), and the
    image is normalised by b, the mean luminance of the large steps
    (EstimateMLTNormConst analogue, GPUOCLLayer.cpp:1175).

The port's rules where the JAX package leans on XLA:
  * u32 products and sums wrap through ops/rng.mul32 / add32;
  * the splat is index_add_ (many chains land in one pixel);
  * b is the float64 host sum of the per-step large-step luminances, in
    step order, read once at the end (the JAX package reads it once a step:
    the same numbers);
  * a burn-in step splats nowhere (the JAX package splats it into an image
    it then drops).
Entry point: render_mlt, on `device` ("cuda" unless asked).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from hydracore_tpu_torch.integrators.pt import (DG_ALPHA, DG_BSDF, DG_LIGHT,
                                                DG_RR, make_eye_rays,
                                                pt_trace)
from hydracore_tpu_torch.ops import rng
from hydracore_tpu_torch.scene.scene import check_supported
from hydracore_tpu_torch.utils.device import resolve_device

P_LARGE = 0.3
S1, S2 = 1.0 / 1024.0, 1.0 / 64.0  # small-step mutation scale (Kelemen)

# the psv's place of each bounce's groups: (offset in the bounce's 10 dims,
# width); the other groups (SSS medium events, AO probes) lie outside it
_PSV_SLOT = {DG_BSDF: (0, 4), DG_LIGHT: (4, 4), DG_RR: (8, 1),
             DG_ALPHA: (9, 1)}
AUX_SEED = 0x51ED270  # the lane-keyed stream of the groups outside the psv


def clock(dev) -> float:
    """Host seconds after the device's queued work (for `stats` only)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def psv_dims(max_depth: int) -> int:
    # 2 pixel + 2 lens + per-depth (4 bsdf + 4 light + 1 rr + 1 alpha)
    return 4 + 10 * max_depth


def _lum(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def psv_pixels(cam, psv):
    """Pixel, screen jitter and lens of primary-sample vectors psv (R, D):
    (px, py int64, jitter (R, 2), lens (R, 2))."""
    W, H = cam.width, cam.height
    fx = psv[:, 0] * W
    fy = psv[:, 1] * H
    px = torch.clamp(torch.floor(fx).to(torch.int64), 0, W - 1)
    py = torch.clamp(torch.floor(fy).to(torch.int64), 0, H - 1)
    jitter = torch.stack([fx - px, fy - py], -1)
    return px, py, jitter, psv[:, 2:4]


def _trace_from_psv(scene, psv, max_depth: int):
    """Evaluate the path sampler at primary sample vectors psv (R, D).
    Returns (color (R, 3) clamped to [0, 1e6], pixel_flat (R,) int64)."""
    cam = scene.camera
    R = psv.shape[0]
    px, py, jitter, lens = psv_pixels(cam, psv)
    ray_o, ray_d = make_eye_rays(cam, px, py, jitter, lens)
    lane = torch.arange(R, dtype=torch.int64, device=psv.device)

    def rand_fn(depth, group):
        slot = _PSV_SLOT.get(group)
        if slot is None:
            # auxiliary dims outside the primary-sample vector: a hash
            # stream keyed by the lane, not mutated with the chain (the
            # reference decodes non-PSS dims from plain RandomGen, mlt.cl)
            return rng.rand4(lane, depth, group, AUX_SEED)
        base = 4 + 10 * depth + slot[0]
        sl = psv[:, base:base + slot[1]]
        if slot[1] < 4:
            sl = torch.cat([sl, sl.new_zeros((R, 4 - slot[1]))], 1)
        return sl

    color, _ = pt_trace(scene, ray_o, ray_d, None, None, max_depth,
                        rand_fn=rand_fn, has_alpha=False)
    return torch.clamp(color, 0.0, 1e6), py * cam.width + px


def _mutate(u, key_idx, step_idx: int, seed: int, p_large: float = P_LARGE,
            step_power: float = 1024.0, step_size: float = 1.0):
    """Large/small-step proposal for all chains. u: (R, D); key_idx (R,)
    u32 chain keys (int64). Returns (proposal (R, D), large (R,) bool).

    step_power/step_size are the reference's HRT_MMLT_STEP_SIZE_POWER
    (512 = large, 1024 = normal, 2048 = small) and
    HRT_MMLT_STEP_SIZE_COEFF (>1 shrinks steps) — statefile
    <mmlt_step_power>/<mmlt_step_size> (RenderDriverRTE.cpp:264-282).
    Defaults reproduce the Kelemen (1/1024, 1/64) scales."""
    R, D = u.shape
    step = step_idx & rng.M32
    base = rng.mul32(key_idx & rng.M32, 0x01000193) ^ step
    large = rng.rand1(base, 0, 11, seed) < p_large

    dims = torch.arange(D, dtype=torch.int64, device=u.device)[None, :]
    lane_seed = (seed & rng.M32) ^ ((step * 2654435761) & rng.M32)
    h = rng.pcg3d(torch.stack([
        torch.broadcast_to(base[:, None], (R, D)),
        torch.broadcast_to(rng.add32(dims, 0x9E3779B9), (R, D)),
        torch.full((R, D), lane_seed, dtype=torch.int64, device=u.device),
    ], dim=-1))
    u1 = (h[..., 0] >> 8).to(torch.float32) * (1.0 / 16777216.0)
    u2 = (h[..., 1] >> 8).to(torch.float32) * (1.0 / 16777216.0)

    # Kelemen small step: dv = s2 * exp(-log(s2/s1) * u), signed;
    # s1 = 1/step_power, s2 = 16/step_power (ratio fixed at 16 like the
    # default S1/S2), shrunk by the step_size coefficient
    dv = (16.0 / step_power / step_size) * torch.exp(-math.log(16.0) * u1)
    dv = torch.where(u2 < 0.5, dv, -dv)
    small = u + dv
    small = small - torch.floor(small)
    # u1 doubles as the fresh uniforms of a large step (an independent hash)
    return torch.where(large[:, None], u1, small), large


def mlt_step(scene, fb, chain_u, chain_f, chain_c, chain_pix, step_idx: int,
             seed: int, max_depth: int = 5, step_power: float = 1024.0,
             step_size: float = 1.0):
    """One Metropolis mutation for all chains; splats both states into fb
    ((H*W, 3), in place; None splats nothing). Returns (fb, chain_u,
    chain_f, chain_c, chain_pix, b_acc, b_cnt): b_* (0-d tensors) are the
    large-step luminance sum and count of the normalisation constant."""
    R = chain_u.shape[0]
    key_idx = torch.arange(R, dtype=torch.int64, device=chain_u.device)

    prop_u, large = _mutate(chain_u, key_idx, step_idx, seed,
                            step_power=step_power, step_size=step_size)
    prop_c, prop_pix = _trace_from_psv(scene, prop_u, max_depth)
    prop_f = _lum(prop_c)

    b_acc = torch.where(large, prop_f, 0.0).sum()
    b_cnt = large.sum().to(torch.float32)

    # standard Metropolis ratio; chains start in f>0 states (burn-in
    # resampling), so no forced acceptance from zero states — that would
    # inject non-f-proportional mass into dim regions (measured +30% bias)
    a = torch.clamp(prop_f / torch.clamp(chain_f, min=1e-12), 0.0, 1.0)

    if fb is not None:  # splat both states (Veach weighting)
        w_old = torch.where(chain_f > 0,
                            (1.0 - a) / torch.clamp(chain_f, min=1e-12), 0.0)
        w_new = torch.where(prop_f > 0, a / torch.clamp(prop_f, min=1e-12),
                            0.0)
        fb.index_add_(0, chain_pix, chain_c * w_old[:, None])
        fb.index_add_(0, prop_pix, prop_c * w_new[:, None])

    # accept/reject (randomness folds the global step index)
    u_acc = rng.rand1(key_idx, step_idx, 13, (seed & rng.M32) ^ 0x5BD1E995)
    acc = u_acc < a
    chain_u = torch.where(acc[:, None], prop_u, chain_u)
    chain_f = torch.where(acc, prop_f, chain_f)
    chain_c = torch.where(acc[:, None], prop_c, chain_c)
    chain_pix = torch.where(acc, prop_pix, chain_pix)
    return fb, chain_u, chain_f, chain_c, chain_pix, b_acc, b_cnt


def init_chains(scene, R: int, seed: int, max_depth: int):
    """Uniform primary-sample vectors from the counter-based RNG, traced,
    then resampled in proportion to their luminance (the reference's
    MMLTSelectSampleProportionalToContrib, mlt.cl:101): systematic
    resampling over the R candidates with a float64 CDF on the host, so
    every chain starts in the stationary distribution's support. Returns
    (chain_u, chain_f, chain_c, chain_pix)."""
    dev = scene.tri_attr.device
    D = psv_dims(max_depth)
    key = torch.arange(R, dtype=torch.int64, device=dev)
    dims = torch.arange(D, dtype=torch.int64, device=dev)[None, :]
    h = rng.pcg3d(torch.stack([
        torch.broadcast_to(key[:, None], (R, D)),
        torch.broadcast_to(dims, (R, D)),
        torch.full((R, D), seed & rng.M32, dtype=torch.int64, device=dev),
    ], dim=-1))
    chain_u = (h[..., 0] >> 8).to(torch.float32) * (1.0 / 16777216.0)
    chain_c, chain_pix = _trace_from_psv(scene, chain_u, max_depth)
    chain_f = _lum(chain_c)

    f_np = chain_f.cpu().numpy().astype(np.float64)
    if f_np.sum() > 0:
        cdf = np.cumsum(f_np)
        cdf /= cdf[-1]
        # stratified picks from the counter RNG (the same PCG3D stream
        # family as every other random number of the renderer)
        jit_u = rng.rand1(key, 0, 23, seed).cpu().numpy().astype(np.float64)
        rs = (np.arange(R, dtype=np.float64) + jit_u) / R
        pick = torch.as_tensor(np.searchsorted(cdf, rs).clip(0, R - 1)
                               .astype(np.int64), device=dev)
        chain_u, chain_c = chain_u[pick], chain_c[pick]
        chain_pix, chain_f = chain_pix[pick], chain_f[pick]
    return chain_u, chain_f, chain_c, chain_pix


def render_mlt(scene, n_passes: int, n_chains: int | None = None,
               mutations_per_pass: int = 16, seed: int = 777,
               max_depth: int | None = None, burn_in: int = 8,
               step_power: float | None = None,
               step_size: float | None = None, device=None,
               stats: dict | None = None) -> torch.Tensor:
    """Metropolis render -> (H, W, 3) f32 on `device` ("cuda" unless
    asked). Image = splats * b * W * H / n_samples, b the mean path
    luminance of the large steps. The first burn_in * mutations_per_pass
    of the n_passes * mutations_per_pass steps splat nowhere. A `stats`
    dict receives the steps, the accepted proposals (a 0-d tensor), b, and
    the seconds of the start (tracing and resampling the first states) and
    of the mutation loop (the device synchronised around each)."""
    dev = resolve_device(device)
    check_supported(scene)
    md = max_depth or scene.settings.trace_depth
    st = scene.settings
    sp = float(step_power if step_power is not None
               else getattr(st, "mmlt_step_power", 1024.0))
    sc = float(step_size if step_size is not None
               else getattr(st, "mmlt_step_size", 1.0))
    scene = scene.to(dev)
    H, W = scene.camera.height, scene.camera.width
    R = n_chains or (W * H)

    if stats is not None:
        t0 = clock(dev)
    chain_u, chain_f, chain_c, chain_pix = init_chains(scene, R, seed, md)
    if stats is not None:
        t1 = clock(dev)
    fb = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    b_acc, b_cnt = [], []
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    total_mut = 0
    n_steps = n_passes * mutations_per_pass
    n_burn = burn_in * mutations_per_pass
    for s in range(n_steps):
        counted = s >= n_burn
        prev_u = chain_u
        _, chain_u, chain_f, chain_c, chain_pix, ba, bc = mlt_step(
            scene, fb if counted else None, chain_u, chain_f, chain_c,
            chain_pix, s, seed, md, sp, sc)
        if stats is not None:
            accepted = accepted + (chain_u != prev_u).any(dim=1).sum()
        total_mut += int(counted)
        b_acc.append(ba)
        b_cnt.append(bc)
    if stats is not None:
        stats.update(start_s=t1 - t0, loop_s=clock(dev) - t1)

    # the host's float64 sums in step order (one read for the whole run)
    b_sum = b_n = 0.0
    if n_steps:
        for ba, bc in torch.stack([torch.stack(b_acc), torch.stack(b_cnt)],
                                  1).cpu().numpy().astype(np.float64):
            b_sum += float(ba)
            b_n += float(bc)
    b = b_sum / max(b_n, 1.0)
    if stats is not None:
        stats.update(steps=n_steps, accepted=accepted, b=b)
    n_samples = total_mut * R
    return fb.reshape(H, W, 3) * (b * W * H / max(n_samples, 1))
