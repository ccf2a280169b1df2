"""Per-stage render statistics: the MRaysStat analogue.

The JAX package's utils/stats.py (reference timing harness cglobals.h:1764
MRaysStat, filled by clFinish-bracketed timers in GPUOCLLayerCore.cpp:16-128
and printed by RenderDriverRTE::Draw) on the port: the stages are timed by
running the traversal (ops/trace_api.py: kernels B1 and B2, B3 or B4, by
the scene's traversal) and whole passes (render_passes), each timing
fenced by torch.cuda.synchronize() on the card; throughput counters
(Mrays/s, Msamples/s) come from the integrator's ray counter.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch


@dataclass
class MRaysStat:
    """Aggregated per-pass statistics (reference field names kept)."""

    raysPerSec: float = 0.0  # Mrays/s, all traversals
    samplesPerSec: float = 0.0  # Msamples/s, full paths
    traversalTimeMs: float = 0.0
    shadowTimeMs: float = 0.0
    shadeTimeMs: float = 0.0  # everything that is not traversal
    samLightTimeMs: float = 0.0
    bounceTimeMs: float = 0.0  # one full bounce
    sampleTimeMs: float = 0.0  # one full sample (all bounces)
    tracePercent: float = 0.0
    passes: int = 0

    def summary(self) -> str:
        return (
            f"[stat] rays/sec({self.raysPerSec:.1f}M) "
            f"samples/sec({self.samplesPerSec:.2f}M) "
            f"trace({self.traversalTimeMs:.1f}ms) shadow({self.shadowTimeMs:.1f}ms) "
            f"shade({self.shadeTimeMs:.1f}ms) sample({self.sampleTimeMs:.1f}ms) "
            f"trace%({self.tracePercent:.0f})"
        )


N_LO, N_HI = 2, 6


def profile_pass(scene, n_rays: int = 65536, max_depth: int = 5,
                 seed: int = 777, n_timed: int = 4,
                 device=None, regen: bool = False) -> MRaysStat:
    """Measure stage costs on `device` ("cuda" unless asked).

    Differential timing throughout (bench.py's design): each probe runs
    the op N_LO and N_HI times back to back, chained (the origins of call
    k + 1 step along the rays by t * 1e-7, so every call traces another
    wavefront), and reports (T_hi - T_lo) / (N_hi - N_lo): the fixed cost
    of a probe (set-up, the fence) cancels. `regen` reaches both
    render_passes calls (the JAX package's process-wide HYDRA_REGEN=1)."""
    from hydracore_tpu_torch.integrators.pt import make_eye_rays, render_passes
    from hydracore_tpu_torch.ops import rng as _rng
    from hydracore_tpu_torch.ops.trace_api import any_hit, closest_hit
    from hydracore_tpu_torch.scene.scene import check_supported
    from hydracore_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    check_supported(scene)
    scene = scene.to(dev)
    cam = scene.camera
    W, H = cam.width, cam.height
    R = min(n_rays, W * H)
    pix = torch.arange(R, dtype=torch.int64, device=dev)
    px, py = pix % W, pix // W
    jitter = _rng.screen_sample(torch.zeros(R, dtype=torch.int64, device=dev),
                                pix)
    lens = torch.zeros((R, 2), dtype=torch.float32, device=dev)
    ray_o, ray_d = make_eye_rays(cam, px, py, jitter, lens)

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def trav_n(n):
        o = ray_o
        for _ in range(n):
            t = closest_hit(scene, o, ray_d)[0]
            t_ = torch.where(torch.isfinite(t), t, 0.0)
            o = o + (t_ * 1e-7)[:, None] * ray_d
        fence()

    def shadow_n(n):
        o = ray_o
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(n):
            occ = any_hit(scene, o, ray_d, 1e30)
            o = o + torch.where(occ, 1e-7, 0.0)[:, None] * ray_d
            acc = acc + occ.sum()
        fence()

    def run_pass(n):
        render_passes(scene, 100, seed, n_pass=n, max_depth=max_depth,
                      device=dev, regen=regen)
        fence()

    reps = max(n_timed // 2, 1)  # differential repetitions per rep count

    def diff_time(run):
        """run(n) runs the op n times and waits for it; ms per op."""
        run(N_LO)
        run(N_HI)  # warm both before timing
        ts = {N_LO: 0.0, N_HI: 0.0}
        for _ in range(reps):
            for n in (N_LO, N_HI):
                t0 = time.perf_counter()
                run(n)
                ts[n] += time.perf_counter() - t0
        return (ts[N_HI] - ts[N_LO]) / (reps * (N_HI - N_LO)) * 1e3

    t_trav = diff_time(trav_n)
    t_shadow = diff_time(shadow_n)
    t_sample = diff_time(run_pass)

    _, rays = render_passes(scene, 0, seed, n_pass=1, max_depth=max_depth,
                            device=dev, regen=regen)
    rays = float(rays)

    trav_total = (t_trav + t_shadow) * max_depth * (W * H) / R
    return MRaysStat(
        raysPerSec=rays / max(t_sample, 1e-9) / 1e3,
        samplesPerSec=(W * H) / max(t_sample, 1e-9) / 1e3,
        traversalTimeMs=t_trav,
        shadowTimeMs=t_shadow,
        shadeTimeMs=max(t_sample - trav_total, 0.0),
        bounceTimeMs=t_sample / max_depth,
        sampleTimeMs=t_sample,
        tracePercent=min(trav_total / max(t_sample, 1e-9), 1.0) * 100.0,
        passes=reps,
    )
