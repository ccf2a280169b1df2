"""MMLT — Metropolis light transport over the bidirectional (SBDPT) target
with per-depth chain groups (torch).

The JAX package's integrators/mmlt.py (ref GPUOCLLayerAdvanced.cpp:395
MMLT_Pass, :518 MMLTInitSplitDataUniform, :640 MMLT_BurningIn; mlt.cl:339
MMLTMakeProposal / :205 MMLTAcceptReject / :1472 MMLTConnect):
  * chains are split by total path length k (vertex count), each depth
    group with its own stationary distribution and normalisation; every
    group rides ONE merged wavefront a mutation (lane_k-masked subpaths of
    bdpt._bdpt_core and one framebuffer slab a group);
  * a chain holds a primary-sample vector driving the pixel, the lens and
    the camera and light subpaths' uniforms; a mutation is mlt._mutate's
    Kelemen large/small step;
  * the target is the sum of the luminances of the k-vertex SBDPT
    strategies, every mutation re-tracing both subpaths;
  * both states splat with Veach's (1 - a) / a weights;
  * the burn-in: rounds of uniform probes estimate each group's brightness
    b0_k, which sets the chains a group gets (_alloc_from_b0) and starts
    its b_k estimate; each group's chains start from a
    contribution-proportional resampling of its probes.

Final image = sum_k  splat_k * b_k * (W*H) / n_samples_k.

The port's rules where the JAX package leans on XLA: the per-group sums
(segment_sum) and the splats are index_add_; the pass's n_sub mutations
are a Python loop (lax.fori_loop there), b_acc / b_cnt read on the host
once a pass; HYDRA_MMLT_BURN_ROUNDS is the argument burn_rounds_cap.
Entry points: render_mmlt, probe_depth_alloc, on `device` ("cuda" unless
asked).
"""
from __future__ import annotations

import torch

from hydracore_tpu_torch.integrators.bdpt import (DG_BD_BLEND,
                                                  DG_BD_CAM_BSDF,
                                                  DG_BD_LGT_EMIT, _bdpt_core)
from hydracore_tpu_torch.integrators.mlt import (_lum, _mutate, clock,
                                                 psv_pixels)
from hydracore_tpu_torch.integrators.pt import make_eye_rays
from hydracore_tpu_torch.ops import rng
from hydracore_tpu_torch.scene.scene import check_supported
from hydracore_tpu_torch.utils.device import resolve_device

DG = {"cam": 0, "emit": 1, "lgt": 2}
AUX_SEED = 0x51ED271  # the lane-keyed stream of the blend walk


def psv_dims(k: int) -> int:
    """[2 pixel + 2 lens] + (k-1) camera bounces x4 + emit x4 +
    max(k-2,1) light bounces x4."""
    return 4 + 4 * (k - 1) + 4 + 4 * max(k - 2, 1)


def _contribs_merged(scene, psv, lane_k, kmax: int, max_depth: int):
    """ALL SBDPT strategy contributions for PSS states psv, with every
    lane masked to its own depth group lane_k (the reference packs the
    per-depth thread ranges into ONE megablock,
    GPUOCLLayerAdvanced.cpp:518-595 MMLTInitSplitDataUniform). Returns
    (_bdpt_core's ((s, t), pixel, color) list, own pixel (R,) int64).

    The PSV layout is the K_MAX layout for every lane: [2 pixel + 2 lens] +
    4*(kmax-1) camera-bounce dims + 4 emit dims + 4*max(kmax-2,1)
    light-bounce dims; lanes with smaller k never read the tail."""
    cam = scene.camera
    W, H = cam.width, cam.height
    R = psv.shape[0]
    px, py, jitter, lens = psv_pixels(cam, psv)
    ray_o, ray_d = make_eye_rays(cam, px, py, jitter, lens)
    own_pix = py * W + px
    lane = torch.arange(R, dtype=torch.int64, device=psv.device)

    cam_base = 4
    emit_base = cam_base + 4 * (kmax - 1)
    lgt_base = emit_base + 4

    def rand_fn(depth, group):
        if group == DG_BD_BLEND:
            # blend-walk uniforms sit outside the PSV: a lane-keyed hash
            # stream, not mutated with the chain
            return rng.rand4(lane, depth, group, AUX_SEED)
        if group == DG_BD_CAM_BSDF:
            base = cam_base + 4 * depth
        elif group == DG_BD_LGT_EMIT:
            base = emit_base
        else:  # light bsdf at depth j+1 -> slice j
            base = lgt_base + 4 * (depth - 1)
        return psv[:, base:base + 4]

    # n_splat = W*H: a t'=1 (connect-to-eye) strategy splats to a pixel
    # chosen by geometry, not by the PSS pixel dims — its u-integral lacks
    # the 1/(W*H) pixel-selection suppression every own-pixel strategy
    # has, so its contribution (and its density in the MIS walk) must be
    # divided by the screen sample count exactly as in a BDPT pass. With
    # n_splat=1 splat-carried transport (e.g. a bulb in a glass shell)
    # renders W*H times too bright.
    out = _bdpt_core(scene, ray_o, ray_d, rand_fn, own_pix, float(W * H),
                     max_depth, "full", lane_k=lane_k, with_labels=True)
    return out, own_pix


def _eval_merged(scene, psv, lane_k, kmax: int, max_depth: int):
    """Stacked (pix (R,S) int64, colors (R,S,3), f (R,)) for PSS states,
    every lane evaluating only its own depth group's strategies."""
    out, _ = _contribs_merged(scene, psv, lane_k, kmax, max_depth)
    pix = torch.stack([p for _l, p, _ in out], dim=1)
    col = torch.stack([c for _l, _, c in out], dim=1)
    return pix, col, _lum(col).sum(dim=1)


def _mmlt_step_merged(scene, fb, u, f, pix_s, col_s, lane_k, gid,
                      step_idx: int, seed: int, n_grp: int, kmax: int,
                      max_depth: int, step_power: float, step_size: float,
                      hw: int):
    """One mutation for ALL depth groups at once; splats both states into
    the per-group framebuffer stack fb (n_grp*H*W, 3), in place. Returns
    (fb, u, f, pix_s, col_s, b_acc (n_grp,), b_cnt (n_grp,))."""
    R = u.shape[0]
    key_idx = rng.add32(torch.arange(R, dtype=torch.int64, device=u.device),
                        0x9E3779B9)

    prop_u, large = _mutate(u, key_idx, step_idx, seed,
                            step_power=step_power, step_size=step_size)
    p_pix, p_col, p_f = _eval_merged(scene, prop_u, lane_k, kmax, max_depth)

    # per-depth-group large-step brightness (the b_k estimator stream)
    z = torch.zeros((n_grp,), dtype=torch.float32, device=u.device)
    b_acc = z.index_add(0, gid, torch.where(large, p_f, 0.0))
    b_cnt = z.index_add(0, gid, large.to(torch.float32))

    a = torch.clamp(p_f / torch.clamp(f, min=1e-12), 0.0, 1.0)
    w_old = torch.where(f > 0, (1.0 - a) / torch.clamp(f, min=1e-12), 0.0)
    w_new = torch.where(p_f > 0, a / torch.clamp(p_f, min=1e-12), 0.0)
    S = p_col.shape[1]
    off = (gid.to(torch.int64) * hw)[:, None]  # the group's framebuffer slab
    fb.index_add_(0, (pix_s + off).reshape(-1),
                  (col_s * w_old[:, None, None]).reshape(R * S, 3))
    fb.index_add_(0, (p_pix + off).reshape(-1),
                  (p_col * w_new[:, None, None]).reshape(R * S, 3))

    u_acc = rng.rand1(key_idx, step_idx, 17, (seed & rng.M32) ^ 0x5BD1E995)
    acc = u_acc < a
    u = torch.where(acc[:, None], prop_u, u)
    f = torch.where(acc, p_f, f)
    pix_s = torch.where(acc[:, None], p_pix, pix_s)
    col_s = torch.where(acc[:, None, None], p_col, col_s)
    return fb, u, f, pix_s, col_s, b_acc, b_cnt


def mmlt_steps(scene, fb, u, f, pix_s, col_s, lane_k, gid, step_base: int,
               seed: int, n_grp: int, kmax: int, max_depth: int, n_sub: int,
               step_power: float = 1024.0, step_size: float = 1.0,
               hw: int = 0, accepted=None):
    """n_sub mutations of ALL depth groups, steps step_base..+n_sub-1.
    Returns (fb, u, f, pix_s, col_s, b_acc (n_grp,), b_cnt (n_grp,)), the
    b_* summed over the steps in float32 on the device. `accepted`, a list,
    receives each step's count of accepted proposals (0-d tensors)."""
    ba = torch.zeros((n_grp,), dtype=torch.float32, device=u.device)
    bn = torch.zeros_like(ba)
    for i in range(n_sub):
        prev_u = u
        fb, u, f, pix_s, col_s, ba_i, bn_i = _mmlt_step_merged(
            scene, fb, u, f, pix_s, col_s, lane_k, gid,
            (step_base + i) & rng.M32, seed, n_grp, kmax, max_depth,
            step_power, step_size, hw)
        ba = ba + ba_i
        bn = bn + bn_i
        if accepted is not None:
            accepted.append((u != prev_u).any(dim=1).sum())
    return fb, u, f, pix_s, col_s, ba, bn


def _init_psv(Rk: int, D: int, k: int, seed: int, salt: int = 0,
              device="cpu"):
    """Uniform PSS states from the counter-based RNG (no host entropy)."""
    key = rng.add32(torch.arange(Rk, dtype=torch.int64, device=device),
                    salt & rng.M32)
    dims = torch.arange(D, dtype=torch.int64, device=device)[None, :]
    h = rng.pcg3d(torch.stack([
        torch.broadcast_to(key[:, None], (Rk, D)),
        torch.broadcast_to(rng.add32(dims, (k * 977) & rng.M32), (Rk, D)),
        torch.full((Rk, D), seed & rng.M32, dtype=torch.int64,
                   device=device)], dim=-1))
    return (h[..., 0] >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _resample_states(u, f, Rk: int, k: int, seed: int):
    """Contribution-proportional systematic resampling to Rk chains —
    MMLT_BurningIn's SelectSampleProportionalToContrib
    (GPUOCLLayerAdvanced.cpp:697-760), on the device with the counter RNG
    (one jittered pick per 1/Rk slice of a float32 CDF). Returns (u, f);
    pix/col of the starts come from one merged re-eval."""
    cdf = torch.cumsum(f, 0)
    total = cdf[-1]
    lane = torch.arange(Rk, dtype=torch.int64, device=u.device)
    jit = rng.rand1(lane, k, 23, seed)
    r = (lane.to(torch.float32) + jit) / Rk * total
    pick = torch.clamp(torch.searchsorted(cdf, r), 0, f.shape[0] - 1)
    return u[pick], f[pick]


def _probe_alloc(scene, ks, md, R_total, probe_chains, seed, salt=0):
    """ONE merged probe round: per-depth brightness b0_k from uniform
    states of every depth group in one wavefront (one host read). Returns
    ({k: (u_k, f_k)}, {k: b0_k})."""
    dev = scene.tri_attr.device
    kmax = ks[-1]
    lane_k = torch.as_tensor(ks, dtype=torch.int64,
                             device=dev).repeat_interleave(probe_chains)
    u = _init_psv(probe_chains * len(ks), psv_dims(kmax), 0, seed, salt, dev)
    _, _, f = _eval_merged(scene, u, lane_k, kmax, md)
    pools = {k: (u[gi * probe_chains:(gi + 1) * probe_chains],
                 f[gi * probe_chains:(gi + 1) * probe_chains])
             for gi, k in enumerate(ks)}
    sums = torch.stack([p[1].sum() for p in pools.values()]).tolist()
    return pools, dict(zip(ks, sums))


def _alloc_from_b0(b0, R_total):
    w_total = sum(b0.values())
    if w_total <= 0.0:
        return {}
    alloc = {}
    for k, b in b0.items():
        if b <= 0.0:
            continue  # no transport at this depth
        share = int(R_total * b / w_total)
        alloc[k] = max(256, (share + 255) // 256 * 256)
    return alloc


def probe_depth_alloc(scene, n_chains: int, seed: int = 777,
                      max_depth: int | None = None, k_min: int = 2,
                      probe_chains: int = 2048, device=None):
    """Public view of the per-depth chain allocation (the reference's
    MMLTInitSplitDataUniform + contribution scale table,
    GPUOCLLayerAdvanced.cpp:518,859) — for tests and diagnostics."""
    dev = resolve_device(device)
    check_supported(scene)
    md = max_depth or scene.settings.trace_depth
    _, b0 = _probe_alloc(scene.to(dev), list(range(k_min, md + 2)), md,
                         n_chains, probe_chains, seed)
    return _alloc_from_b0(b0, n_chains)


def render_mmlt(scene, n_passes: int, n_chains: int | None = None,
                mutations_per_pass: int = 16, seed: int = 777,
                max_depth: int | None = None, burn_in: int | None = None,
                k_min: int = 2, probe_chains: int = 2048,
                step_power: float | None = None,
                step_size: float | None = None, burn_rounds_cap: int = 16,
                device=None, stats: dict | None = None) -> torch.Tensor:
    """Multiplexed-style Metropolis over SBDPT -> (H, W, 3) f32 on `device`
    ("cuda" unless asked). A `stats` dict receives the burn rounds, the
    allocation {k: chains}, b_k, the steps, the accepted proposals (a 0-d
    tensor) and the seconds of the burn-in (probe rounds, allocation,
    resampling and the first states' evaluation) and of the mutation loop
    (the device synchronised around each)."""
    dev = resolve_device(device)
    check_supported(scene)
    md = max_depth or scene.settings.trace_depth
    st = scene.settings
    sp = float(step_power if step_power is not None
               else getattr(st, "mmlt_step_power", 1024.0))
    sc = float(step_size if step_size is not None
               else getattr(st, "mmlt_step_size", 1.0))
    # <mmlt_burn_iters> (default 1024, RenderDriverRTE.cpp:246-249) counts
    # UNIFORM-SAMPLE burn rounds: the reference's MMLT_BurningIn runs
    # BURN_ITERS iterations of MEGABLOCK fresh uniform evaluations,
    # averaging brightness over all of them and selecting
    # contribution-proportional initial states (GPUOCLLayerAdvanced.cpp:
    # 199-300); it discards no post-selection Markov step. The shape is
    # kept (burn rounds of uniform probes -> pooled b estimate ->
    # proportional resampling) with probe_chains-wide rounds, at most
    # burn_rounds_cap of them (the reference burns 1024 x 256k
    # evaluations; 16 x 2048 by default).
    if burn_in is None:
        burn_in = int(getattr(st, "mmlt_burn_iters", 1024))
    burn_rounds = max(1, min(int(burn_in), int(burn_rounds_cap)))
    H, W = scene.camera.height, scene.camera.width
    ks = list(range(k_min, md + 2))  # path vertex counts
    R_total = n_chains or (W * H)
    scene = scene.to(dev)
    n_steps = n_passes * mutations_per_pass
    kmax = ks[-1]

    # ---- burn-in rounds (one merged wavefront a round covers every depth
    # group): per-depth brightness b0_k from uniform states, the pooled
    # resampling source, and the per-depth chain allocation
    # (MMLTInitSplitDataUniform + contribution table,
    # GPUOCLLayerAdvanced.cpp:518,859)
    if stats is not None:
        t0 = clock(dev)
    b_pool: dict = {k: [] for k in ks}
    b0 = {k: 0.0 for k in ks}
    for rnd in range(burn_rounds):
        pools, b0_r = _probe_alloc(scene, ks, md, R_total, probe_chains,
                                   seed, salt=(0x9E3779B9 * rnd) & rng.M32)
        for k in ks:
            b_pool[k].append(pools[k])
            b0[k] += b0_r[k]
    alloc = _alloc_from_b0(b0, R_total)
    if stats is not None:
        stats.update(burn_rounds=burn_rounds, alloc=dict(alloc), steps=0,
                     accepted=torch.zeros((), dtype=torch.int64, device=dev),
                     b={})
    if not alloc:
        return torch.zeros((H, W, 3), dtype=torch.float32, device=dev)

    # ---- contribution-proportional starts per group, then ONE merged
    # chain wavefront: lane_k / gid tag each lane's depth group
    n_grp = len(alloc)
    us, lanes, gids = [], [], []
    for gi, (k, Rk) in enumerate(alloc.items()):
        u_p = torch.cat([p[0] for p in b_pool[k]])
        f_p = torch.cat([p[1] for p in b_pool[k]])
        u_k, _ = _resample_states(u_p, f_p, Rk, k,
                                  (seed ^ 0xA511E9B3) & rng.M32)
        us.append(u_k)
        lanes.append(torch.full((Rk,), k, dtype=torch.int64, device=dev))
        gids.append(torch.full((Rk,), gi, dtype=torch.int64, device=dev))
    del b_pool
    u = torch.cat(us)
    lane_k = torch.cat(lanes)
    gid = torch.cat(gids)
    pix_s, col_s, f = _eval_merged(scene, u, lane_k, kmax, md)
    if stats is not None:
        t1 = clock(dev)

    fb = torch.zeros((n_grp * H * W, 3), dtype=torch.float32, device=dev)
    # the burn rounds' uniforms already sampled b_k's estimator
    b_sum = {k: b0[k] for k in alloc}
    b_n = {k: float(probe_chains * burn_rounds) for k in alloc}
    total_mut = 0
    accepted = [] if stats is not None else None
    # one host read a pass: mutations_per_pass mutations of EVERY group
    for s0 in range(0, n_steps, mutations_per_pass):
        n_sub = min(mutations_per_pass, n_steps - s0)
        fb, u, f, pix_s, col_s, ba, bc = mmlt_steps(
            scene, fb, u, f, pix_s, col_s, lane_k, gid, s0,
            seed & rng.M32, n_grp, kmax, md, n_sub, sp, sc, hw=H * W,
            accepted=accepted)
        total_mut += n_sub
        ba_h, bc_h = torch.stack([ba, bc]).cpu().numpy()
        for gi, k in enumerate(alloc):
            b_sum[k] += float(ba_h[gi])
            b_n[k] += float(bc_h[gi])
    if stats is not None:
        stats.update(burn_s=t1 - t0, loop_s=clock(dev) - t1)

    fb_h = fb.to(torch.float64).reshape(n_grp, H * W, 3)
    img = torch.zeros((H * W, 3), dtype=torch.float64, device=dev)
    b_k = {}
    for gi, (k, Rk) in enumerate(alloc.items()):
        b_k[k] = b_sum[k] / max(b_n[k], 1.0)
        n_samples = total_mut * Rk
        img += fb_h[gi] * (b_k[k] * W * H / max(n_samples, 1))
    if stats is not None:
        stats.update(steps=n_steps, b=b_k, accepted=(
            torch.stack(accepted).sum() if accepted else stats["accepted"]))
    return img.reshape(H, W, 3).to(torch.float32)
