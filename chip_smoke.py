"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's native code from the checkout (csrc/ -> the git-ignored
hydracore_tpu_torch/_build/), then:
  1. holds kernels B1 (closest hit) and B2 (any hit) against their plain
     PyTorch twin on the card at the main path's shapes, and times both;
  2. drives the main path — render_passes of the MIS+NEE path tracer — on
     the full-size procedural scene (bench_scene: 26,252 triangles) at
     1024x1024, depth 5, seed 777, and checks that it went through B1 and B2;
  3. renders the scene at 64x64, 8 spp once on the card (kernels) and once
     on the CPU (twins) and compares the images.
Any failed check raises: the script then exits non-zero and prints no
result line. On success the last line is the JSON result
{"ok": true, "device": {...}}; the line before it the card's name and power
limit; before that a "kernels" JSON line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 777
WIDTH = HEIGHT = 1024
DEPTH = 5
N_PASS = 4
# NVIDIA H100 SXM data sheet: HBM rate and f32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# operations the traversal needs: a ray-box slab test (6 mul-sub pairs,
# 10 min/max, 2 compares) and one lane's Woop test (the w row dot products,
# the divide and the t range test; u, v only for the rare candidates)
OPS_BOX = 24
OPS_LANE = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Median device time of fn() over `reps` runs (CUDA events)."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def needed_visits(scene, rays, t_end) -> tuple[int, int]:
    """(active rays, ray-cluster pairs whose box a ray enters before its
    final t): the box tests and Woop blocks this run's data needs."""
    from hydracore_tpu_torch.ops.traverse_cluster import BIG

    flat = rays.reshape(-1, 8)
    act = flat[:, 7] > 0
    b = scene.cl_bounds_oct[0]
    b = b[:, b[0] < 1e29]  # real clusters
    n_act = int(act.sum())
    visits = 0
    for s in range(0, flat.shape[0], 16384):
        f = flat[s:s + 16384]
        d = f[:, 3:6]
        inv = 1.0 / torch.where(d.abs() < 1e-12,
                                torch.where(d < 0, -1e-12, 1e-12), d)
        ta = (b[None, 0:3] - f[:, 0:3, None]) * inv[:, :, None]
        tb = (b[None, 3:6] - f[:, 0:3, None]) * inv[:, :, None]
        tn = torch.minimum(ta, tb).amax(dim=1)
        tf = torch.maximum(ta, tb).amin(dim=1)
        te = t_end[s:s + 16384]
        te = torch.where(te <= -BIG * 0.5, f[:, 6], te)[:, None]
        hit = (tf >= tn.clamp(min=0)) & (tn < te) & act[s:s + 16384, None]
        visits += int(hit.sum())
    return n_act, visits


def bound_ms(scene, rays, t_end) -> tuple[float, str]:
    n = rays.shape[0] * rays.shape[1]
    Cp = scene.cl_tris.shape[0]
    bytes_ = n * 8 * 4 + n * 8 + Cp * (8 * 8 * 4 + 4 * 384 * 4 + 8 * 4)
    n_act, visits = needed_visits(scene, rays, t_end)
    C = int((scene.cl_bounds_oct[0][0] < 1e29).sum())
    ops = n_act * C * OPS_BOX + visits * 128 * OPS_LANE
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def profile_pass(pt, scene, card: str) -> None:
    """torch.profiler over one 1024x1024 pass: wall time, device busy time
    and the kernels that take it, largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        pt.render_passes(scene, 200, SEED, n_pass=1, max_depth=DEPTH,
                         device=scene.tri_attr.device)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    if busy <= 0.0:
        log("phase 5 profile: device time not measured (no CUDA events)")
        return
    log(f"phase 5 profile, one pass: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%), {sum(e.count for e in evs)} "
        f"kernel launches [{card}]")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"phase 5   {ms:9.3f} ms {100 * ms / busy:5.1f}% x{e.count:5d} "
            f"{e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from hydracore_tpu_torch.integrators import pt
    from hydracore_tpu_torch.ops import traverse_cluster as tc
    from hydracore_tpu_torch.ops.trace_api import closest_hit, coherence_order
    from hydracore_tpu_torch.scene.procedural import bench_scene
    from hydracore_tpu_torch.utils import build
    from hydracore_tpu_torch.utils.math3d import (make_orthonormal_basis,
                                                  offs_ray_pos)

    dev = torch.device("cuda")
    card = gpu_name_power()

    # ---- phase 1: build every native source, compilers in parallel
    t0 = time.time()
    srcs = ["traverse_cluster.cu", "bvh_builder.cpp"]
    started = {s: build.start_build(s) for s in srcs}
    for s in srcs:
        build.finish_build(s, started[s])
    tc._kernel_lib()
    log(f"phase 1 build: {time.time() - t0:.2f} s ({', '.join(srcs)})")

    # ---- phase 2: full-size scene
    t0 = time.time()
    host_scene = bench_scene(WIDTH, HEIGHT, DEPTH)
    scene = host_scene.to(dev)
    n_clusters = int((host_scene.cl_bounds_oct[0][0] < 1e29).sum())
    log(f"phase 2 scene: {host_scene.num_triangles} triangles, {n_clusters} "
        f"clusters (Cp {host_scene.cl_tris.shape[0]}), built in "
        f"{time.time() - t0:.2f} s")

    # ---- phase 3: kernels against their twin at the main path's shapes
    # every 4th primary ray of the frame in Morton order: MEGABLOCK rays
    # spread over the whole image (shadows of both spheres included)
    ray_o, ray_d, _, _ = pt.primary_rays(scene, [0], SEED)
    ray_o, ray_d = ray_o[::4].contiguous(), ray_d[::4].contiguous()
    t, tri, u, v = closest_hit(scene, ray_o, ray_d)
    hit = tri >= 0
    pos, n, ng, _, _, _, _ = pt.compute_hit(scene, tri, u, v, ray_o, ray_d, t)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    rnd = torch.rand((ray_o.shape[0], 4), generator=g).to(dev)
    ns = torch.where((n * ray_d).sum(-1, keepdim=True) < 0, n, -n)
    ngs = torch.where((ng * ray_d).sum(-1, keepdim=True) < 0, ng, -ng)
    tb, bb = make_orthonormal_basis(ns)
    ct = rnd[:, 0].sqrt()
    st = (1 - rnd[:, 0]).sqrt()
    ph = 2 * torch.pi * rnd[:, 1]
    wi = (st * ph.cos())[:, None] * tb + (st * ph.sin())[:, None] * bb + ct[:, None] * ns
    bo = offs_ray_pos(pos, ngs, wi)
    perm = coherence_order(scene, bo, wi, hit)
    bounce_o, bounce_d, bounce_act = bo[perm], wi[perm], hit[perm]
    # shadow rays: hit points to uniform points on the rect light
    lt = host_scene.lights
    lp = (lt.pos[0].to(dev) + (2 * rnd[:, 2:3] - 1) * lt.vx[0].to(dev)
          + (2 * rnd[:, 3:4] - 1) * lt.vy[0].to(dev))
    to_l = lp - pos
    dist = to_l.norm(dim=-1)
    sd = to_l / dist[:, None].clamp(min=1e-12)
    so = offs_ray_pos(pos, ngs, sd)
    perm = coherence_order(scene, so, sd, hit)
    sh_o, sh_d, sh_t, sh_act = so[perm], sd[perm], dist[perm] * 0.995, hit[perm]

    cases = [
        ("B1 primary", tc._to_blocks(ray_o, ray_d, 1e30, None, tc.R_BLK)[0], False),
        ("B1 bounce", tc._to_blocks(bounce_o, bounce_d, 1e30, bounce_act,
                                    tc.R_BLK_BOUNCE)[0], False),
        ("B2 shadow", tc._to_blocks(sh_o, sh_d, sh_t, sh_act, tc.R_BLK)[0], True),
    ]
    pool = (scene.cl_bounds_oct, scene.cl_tris, scene.cl_oct_perm)
    kernels = {}
    for name, rays, any_hit_mode in cases:
        tk, sk = tc.cluster_traverse(rays, *pool, any_hit_mode=any_hit_mode)
        tt, stw = tc.cluster_traverse_plain(rays, *pool, any_hit_mode=any_hit_mode)
        torch.cuda.synchronize()
        hk, ht = sk >= 0, stw >= 0
        if any_hit_mode:
            agree = float((hk == ht).float().mean())
            err = float((hk.float() - ht.float()).abs().max())
            log(f"phase 3 {name}: {rays.shape[0] * rays.shape[1]} rays, "
                f"occluded {int(hk.sum())}, occlusion agrees on {agree:.6f}")
            if agree < 0.9999:
                raise AssertionError(f"{name}: occlusion agrees on {agree}")
        else:
            if not torch.equal(hk, ht):
                raise AssertionError(f"{name}: hit masks differ on "
                                     f"{int((hk != ht).sum())} rays")
            same = float((sk[hk] == stw[hk]).float().mean()) if hk.any() else 1.0
            rel = ((tk[hk] - tt[hk]).abs() / tt[hk].abs().clamp(min=1e-30))
            err = float((tk[hk] - tt[hk]).abs().max()) if hk.any() else 0.0
            log(f"phase 3 {name}: {rays.shape[0] * rays.shape[1]} rays, hits "
                f"{int(hk.sum())}, slots equal on {same:.6f}, t max rel err "
                f"{float(rel.max()) if hk.any() else 0.0:.3e}")
            if same < 0.999:
                raise AssertionError(f"{name}: slots equal on {same}")
            if hk.any() and float(rel.max()) > 1e-5:
                raise AssertionError(f"{name}: t rel err {float(rel.max())}")
        ms = cuda_time_ms(lambda: tc.cluster_traverse(
            rays, *pool, any_hit_mode=any_hit_mode), 20)
        plain = cuda_time_ms(lambda: tc.cluster_traverse_plain(
            rays, *pool, any_hit_mode=any_hit_mode), 3)
        bms, by = bound_ms(scene, rays, tk.reshape(-1))
        log(f"phase 3 {name}: kernel {ms:.4f} ms, twin {plain:.4f} ms, "
            f"bound {bms:.5f} ms ({by}) [{card}]")
        key = "B2" if any_hit_mode else "B1"
        kernels.setdefault(key, []).append((name, ms, plain, bms, by, err))

    # ---- phase 4: the main path at full size through the kernels
    pt.render_passes(scene, 100, SEED, n_pass=1, max_depth=DEPTH, device=dev)
    torch.cuda.synchronize()
    tc.reset_launch_counts()
    t0 = time.time()
    img, rays_traced = pt.render_passes(scene, 0, SEED, n_pass=N_PASS,
                                        max_depth=DEPTH, device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {"B1": tc.closest_launches, "B2": tc.any_launches}
    rays_traced = int(rays_traced)
    log(f"phase 4 main path: closest_launches {launches['B1']}, any_launches "
        f"{launches['B2']}")
    if not bool(torch.isfinite(img).all()) or float(img.sum()) <= 0.0:
        raise AssertionError("main path image is not finite and non-zero")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if launches["B1"] <= 0 or launches["B2"] <= 0:
        raise AssertionError(f"kernels not launched on the main path: {launches}")
    samples = N_PASS * WIDTH * HEIGHT
    log(f"phase 4 main path: {WIDTH}x{HEIGHT} depth {DEPTH} {N_PASS} passes "
        f"in {dt:.3f} s: {samples / dt / 1e6:.4f} Msamples/s, "
        f"{rays_traced / dt / 1e6:.4f} Mrays/s ({rays_traced} rays) [{card}]")

    small = bench_scene(64, 64, DEPTH)
    img_gpu = pt.render(small, spp=8, seed=SEED, device="cuda").cpu()
    img_cpu = pt.render(small, spp=8, seed=SEED, device="cpu")
    close = float(((img_gpu - img_cpu).abs().amax(dim=-1) <= 1e-3).float().mean())
    log(f"phase 4 64x64 8 spp: pixels within 1e-3 of the CPU twins' image: "
        f"{close:.4f}")
    if close < 0.99:
        raise AssertionError(f"card vs CPU image: {close} of pixels agree")

    # ---- phase 5: where the time of one full-frame pass goes
    profile_pass(pt, scene, card)

    rows = []
    for key, src_name in (("B1", "closest hit"), ("B2", "any hit")):
        recs = kernels[key]
        rows.append({
            # times are summed over the phase-3 wavefronts named here
            "name": f"{key} cluster traversal, {src_name} "
                    f"({' + '.join(r[0] for r in recs)})",
            "route": "cuda",
            "source": "hydracore_tpu_torch/csrc/traverse_cluster.cu",
            "replaces": "hydracore_tpu/ops/traverse_cluster.py:576",
            "launches": launches[key],
            "max_abs_err": max(r[5] for r in recs),
            "ms": sum(r[1] for r in recs),
            "plain_ms": sum(r[2] for r in recs),
            "bound_ms": sum(r[3] for r in recs),
            "bound_by": recs[0][4],
            "library_ms": None,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
