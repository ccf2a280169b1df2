"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's native code from the checkout (csrc/ -> the git-ignored
hydracore_tpu_torch/_build/), then drives three main paths of the MIS+NEE
path tracer, render_passes at 1024x1024, depth 5, seed 777, each through its
kernels:
  flat         the procedural bench_scene (26,252 triangles, one flat
               cluster pool) through B1 (closest hit) and B2 (any hit);
  instanced    a cornell box holding 24 transformed instances of one
               25,280-triangle mesh, assembled from a SceneDesc with
               instancing="auto" (over 400,000 flattened triangles), through
               B3 in both hit modes;
  partitioned  bench_scene with its large sphere at 201,600 triangles (a
               pool of three 1024-cluster chunks) through the chunk loop of
               B1 and B2.
For each path it first holds the kernels against their plain PyTorch twin
on the card at the path's shapes (primary, bounce and shadow wavefronts of
2^18 rays) and times both, then resets the launch counters, renders, and
checks the counters. The flat and the instanced scene are also rendered at
64x64, 8 spp on the card (kernels) and on the CPU (twins) and compared; the
instanced one also against the flattened assembly of the same SceneDesc;
the chunked kernels also against the flat-pool kernels on the same
clusters. One pass of each path runs under torch.profiler.
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
import xml.etree.ElementTree as ET

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 777
WIDTH = HEIGHT = 1024
DEPTH = 5
N_PASS = 2
N_INSTANCES = 24
# NVIDIA H100 SXM data sheet: HBM rate and f32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# operations the traversal needs: a ray-box slab test (6 mul-sub pairs,
# 10 min/max, 2 compares), one lane's Woop test (the w row dot products,
# the divide and the t range test; u, v only for the rare candidates), and
# moving a ray into an instance's local space once per instance-cluster it
# enters (18 multiplies and 15 adds)
OPS_BOX = 24
OPS_LANE = 20
OPS_INST = 33


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


def real_boxes(scene):
    """(8, C) boxes of the scene's real clusters (instance-clusters of an
    instanced scene), the chunks of a partitioned pool side by side."""
    b = scene.cl_bounds
    if b.dim() == 3:
        b = b.permute(1, 0, 2).reshape(8, -1)
    return b[:, b[0] < 1e29]


def needed_visits(scene, rays, t_end) -> tuple[int, int]:
    """(active rays, ray-cluster pairs whose box a ray enters before its
    final t): the box tests and Woop blocks this run's data needs,
    whatever walks them."""
    from hydracore_tpu_torch.ops.traverse_cluster import BIG

    flat = rays.reshape(-1, 8)
    act = flat[:, 7] > 0
    b = real_boxes(scene)
    n_act = int(act.sum())
    visits = 0
    step = max(1024, (1 << 26) // max(b.shape[1], 1))
    for s in range(0, flat.shape[0], step):
        f = flat[s:s + step]
        d = f[:, 3:6]
        inv = 1.0 / torch.where(d.abs() < 1e-12,
                                torch.where(d < 0, -1e-12, 1e-12), d)
        ta = (b[None, 0:3] - f[:, 0:3, None]) * inv[:, :, None]
        tb = (b[None, 3:6] - f[:, 0:3, None]) * inv[:, :, None]
        tn = torch.minimum(ta, tb).amax(dim=1)
        tf = torch.maximum(ta, tb).amin(dim=1)
        te = t_end[s:s + step]
        te = torch.where(te <= -BIG * 0.5, f[:, 6], te)[:, None]
        hit = (tf >= tn.clamp(min=0)) & (tn < te) & act[s:s + step, None]
        visits += int(hit.sum())
    return n_act, visits


def bound_ms(scene, rays, t_end) -> tuple[float, str]:
    """The least time the card could take: rays in, t and slot out and the
    scene's traversal arrays once, over the memory rate; box tests for
    every active ray and real cluster, Woop lanes (and for an instanced
    scene the ray's move into local space) for every cluster a ray enters
    before its final t, over the f32 rate."""
    n = rays.shape[0] * rays.shape[1]
    pool = [scene.cl_bounds_oct, scene.cl_tris, scene.cl_oct_perm]
    inst = scene.cl_map is not None
    if inst:
        pool += [scene.cl_map, scene.inst_woop]
    bytes_ = n * 8 * 4 + n * 8 + sum(x.numel() * x.element_size() for x in pool)
    n_act, visits = needed_visits(scene, rays, t_end)
    C = real_boxes(scene).shape[1]
    ops = n_act * C * OPS_BOX + visits * (128 * OPS_LANE
                                          + (OPS_INST if inst else 0))
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def profile_pass(pt, scene, card: str, tag: str) -> None:
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
        log(f"{tag} profile: device time not measured (no CUDA events)")
        return
    log(f"{tag} profile, one pass: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%), {sum(e.count for e in evs)} "
        f"kernel launches [{card}]")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"{tag}   {ms:9.3f} ms {100 * ms / busy:5.1f}% x{e.count:5d} "
            f"{e.key[:90]}")


def wavefronts(pt, tc, scene):
    """The main path's three kinds of wavefront on `scene`, 2^18 rays each:
    every 4th primary ray of the frame in Morton order (spread over the
    whole image), cosine-sampled bounce rays off their hit points and
    shadow rays to uniform points on the rect light (light row 0), the last
    two in coherence order as the path tracer sends them. Returns
    [(name, ray blocks, any_hit_mode)]."""
    from hydracore_tpu_torch.ops.trace_api import closest_hit, coherence_order
    from hydracore_tpu_torch.utils.math3d import (make_orthonormal_basis,
                                                  offs_ray_pos)

    dev = scene.tri_attr.device
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
    lt = scene.lights
    lp = (lt.pos[0] + (2 * rnd[:, 2:3] - 1) * lt.vx[0]
          + (2 * rnd[:, 3:4] - 1) * lt.vy[0])
    to_l = lp - pos
    dist = to_l.norm(dim=-1)
    sd = to_l / dist[:, None].clamp(min=1e-12)
    so = offs_ray_pos(pos, ngs, sd)
    perm = coherence_order(scene, so, sd, hit)
    sh_o, sh_d, sh_t, sh_act = so[perm], sd[perm], dist[perm] * 0.995, hit[perm]
    return [
        ("primary", tc._to_blocks(ray_o, ray_d, 1e30, None, tc.R_BLK)[0], False),
        ("bounce", tc._to_blocks(bounce_o, bounce_d, 1e30, bounce_act,
                                 tc.R_BLK_BOUNCE)[0], False),
        ("shadow", tc._to_blocks(sh_o, sh_d, sh_t, sh_act, tc.R_BLK)[0], True),
    ]


def scene_pool(scene) -> dict:
    return dict(cbl_oct=scene.cl_bounds_oct, tris=scene.cl_tris,
                perm=scene.cl_oct_perm, cl_map=scene.cl_map,
                inst_woop=scene.inst_woop)


def check_kernels(tag, tc, scene, cases, card, flat_scene=None) -> dict:
    """Hold the kernel against its twin on every wavefront of `cases`
    (equal hit masks, slots equal >= 0.999, t rel err <= 1e-5, occlusion
    agreement >= 0.9999), optionally against the flat-pool kernel on
    `flat_scene` (the same clusters re-packed flat: equal hit masks, t and
    triangle equal >= 0.999), and time kernel and twin. Returns
    {"closest": [...], "any": [...]} of (name, ms, plain_ms, bound_ms,
    bound_by, max_abs_err) records."""
    pool = scene_pool(scene)
    out = {"closest": [], "any": []}
    for name, rays, any_hit_mode in cases:
        n_rays = rays.shape[0] * rays.shape[1]
        tk, sk = tc.cluster_traverse(rays, any_hit_mode=any_hit_mode, **pool)
        tt, stw = tc.cluster_traverse_plain(rays, any_hit_mode=any_hit_mode,
                                            **pool)
        torch.cuda.synchronize()
        hk, ht = sk >= 0, stw >= 0
        if any_hit_mode:
            agree = float((hk == ht).float().mean())
            err = float((hk.float() - ht.float()).abs().max())
            log(f"{tag} {name}: {n_rays} rays, occluded {int(hk.sum())}, "
                f"occlusion agrees with the twin on {agree:.6f}")
            if agree < 0.9999:
                raise AssertionError(f"{tag} {name}: occlusion agrees on {agree}")
        else:
            if not torch.equal(hk, ht):
                raise AssertionError(f"{tag} {name}: hit masks differ on "
                                     f"{int((hk != ht).sum())} rays")
            if not hk.any():
                raise AssertionError(f"{tag} {name}: no ray hit anything")
            same = float((sk[hk] == stw[hk]).float().mean())
            rel = float(((tk[hk] - tt[hk]).abs()
                         / tt[hk].abs().clamp(min=1e-30)).max())
            err = float((tk[hk] - tt[hk]).abs().max())
            log(f"{tag} {name}: {n_rays} rays, hits {int(hk.sum())}, slots "
                f"equal to the twin's on {same:.6f}, t max rel err {rel:.3e}")
            if same < 0.999:
                raise AssertionError(f"{tag} {name}: slots equal on {same}")
            if rel > 1e-5:
                raise AssertionError(f"{tag} {name}: t rel err {rel}")
        if flat_scene is not None:
            tf, sf = tc.cluster_traverse(rays, any_hit_mode=any_hit_mode,
                                         **scene_pool(flat_scene))
            if not torch.equal(hk, sf >= 0):
                raise AssertionError(f"{tag} {name}: hit masks differ from the "
                                     "flat-pool kernel's")
            if not any_hit_mode:
                t_same = float((tk[hk] == tf[hk]).float().mean())
                tri_c = scene.cl_slot_tri[sk[hk].long()]
                tri_f = flat_scene.cl_slot_tri[sf[hk].long()]
                tri_same = float((tri_c == tri_f).float().mean())
                log(f"{tag} {name}: against the flat-pool kernel t equal on "
                    f"{t_same:.6f}, triangle equal on {tri_same:.6f}")
                if t_same < 0.999 or tri_same < 0.999:
                    raise AssertionError(f"{tag} {name}: chunked vs flat pool")
        ms = cuda_time_ms(lambda: tc.cluster_traverse(
            rays, any_hit_mode=any_hit_mode, **pool), 20)
        plain = cuda_time_ms(lambda: tc.cluster_traverse_plain(
            rays, any_hit_mode=any_hit_mode, **pool), 2)
        bms, by = bound_ms(scene, rays, tk.reshape(-1))
        log(f"{tag} {name}: kernel {ms:.4f} ms, twin {plain:.4f} ms, "
            f"bound {bms:.5f} ms ({by}) [{card}]")
        out["any" if any_hit_mode else "closest"].append(
            (name, ms, plain, bms, by, err))
    return out


def drive_main_path(tag, pt, tc, scene, card, expect: dict) -> dict:
    """One warm-up pass, then N_PASS passes at full size with the launch
    counters set to 0 just before and read just after. `expect` names the
    counters that must be > 0; every other counter must stay 0."""
    dev = scene.tri_attr.device
    pt.render_passes(scene, 100, SEED, n_pass=1, max_depth=DEPTH, device=dev)
    torch.cuda.synchronize()
    tc.reset_launch_counts()
    t0 = time.time()
    img, rays_traced = pt.render_passes(scene, 0, SEED, n_pass=N_PASS,
                                        max_depth=DEPTH, device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = {k: getattr(tc, k) for k in (
        "closest_launches", "any_launches", "inst_closest_launches",
        "inst_any_launches")}
    rays_traced = int(rays_traced)
    log(f"{tag} main path: launches {counts}")
    if not bool(torch.isfinite(img).all()) or float(img.sum()) <= 0.0:
        raise AssertionError(f"{tag}: image is not finite and non-zero")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"{tag}: image shape {tuple(img.shape)}")
    for k, v in counts.items():
        if (v > 0) != (k in expect):
            raise AssertionError(f"{tag}: launch counts {counts}, expected "
                                 f"exactly {sorted(expect)} to be non-zero")
    samples = N_PASS * WIDTH * HEIGHT
    log(f"{tag} main path: {WIDTH}x{HEIGHT} depth {DEPTH} {N_PASS} passes in "
        f"{dt:.3f} s: {samples / dt / 1e6:.4f} Msamples/s, "
        f"{rays_traced / dt / 1e6:.4f} Mrays/s ({rays_traced} rays) [{card}]")
    return counts


def card_vs_cpu(tag, pt, small) -> torch.Tensor:
    """64x64, 8 spp on the card (kernels) against the CPU (twins): >= 99%
    of pixels within 1e-3. Returns the card's image."""
    img_gpu = pt.render(small, spp=8, seed=SEED, device="cuda").cpu()
    img_cpu = pt.render(small, spp=8, seed=SEED, device="cpu")
    close = float(((img_gpu - img_cpu).abs().amax(dim=-1) <= 1e-3).float().mean())
    log(f"{tag} 64x64 8 spp: pixels within 1e-3 of the CPU twins' image: "
        f"{close:.4f}")
    if close < 0.99:
        raise AssertionError(f"{tag}: card vs CPU image: {close} of pixels agree")
    return img_gpu


def instanced_desc(width: int, height: int):
    """A SceneDesc built in memory: the cornell box and its rect light as
    world geometry (single-use mesh, emitter: both flatten) and
    N_INSTANCES transformed instances (rotation, non-uniform scale,
    translation from SEED) of one sphere mesh of 25,280 triangles,
    tessellated as SceneBuilder.add_sphere does."""
    from hydracore_tpu_torch.scene import statefile as sf
    from hydracore_tpu_torch.scene.procedural import SceneBuilder
    from hydracore_tpu_torch.scene.vsgf import MeshData, make_rect_mesh

    def mesh_of(builder) -> MeshData:
        tris = builder.tris
        T = len(tris)

        def col(k, w):
            a = np.stack([t[k + j] for t in tris for j in range(3)])
            return np.concatenate([a, np.zeros((3 * T, w - a.shape[1]),
                                               np.float32)], 1)

        tang = np.tile(np.array([[1, 0, 0, 0]], np.float32), (3 * T, 1))
        return MeshData(pos=col(0, 4), norm=col(3, 4), tang=tang,
                        texcoord=col(6, 2),
                        indices=np.arange(3 * T, dtype=np.int32).reshape(T, 3),
                        mat_indices=np.asarray([t[9] for t in tris], np.int32))

    walls = SceneBuilder()
    walls.add_box_interior(2.0, 0, 0, 0, 1, 2)
    ball = SceneBuilder()
    ball.add_sphere([0, 0, 0], 1.0, 4, n_seg=160, n_ring=80)

    def lambert(mid, col):
        return ET.fromstring(
            f'<material id="{mid}" type="hydra_material"><diffuse '
            f'brdf_type="lambert"><color val="{col}"/></diffuse></material>')

    materials = {
        0: lambert(0, "0.65 0.65 0.65"), 1: lambert(1, "0.7 0.12 0.1"),
        2: lambert(2, "0.12 0.55 0.18"),
        3: ET.fromstring(
            '<material id="3" type="hydra_material" light_id="0"><emission>'
            '<color val="12 12 12"/><multiplier val="1"/></emission></material>'),
        4: ET.fromstring(
            '<material id="4" type="hydra_material"><diffuse brdf_type="lambert">'
            '<color val="0.3 0.3 0.35"/></diffuse><reflectivity brdf_type="ggx">'
            '<color val="0.6 0.5 0.35"/><glossiness val="0.75"/></reflectivity>'
            '</material>'),
    }
    light = ET.fromstring(
        '<light id="0" type="area" shape="rect" distribution="diffuse" '
        'mat_id="3"><size half_length="0.5" half_width="0.5"/><intensity>'
        '<color val="12 12 12"/><multiplier val="1"/></intensity></light>')
    m_light = np.eye(4, dtype=np.float32)
    m_light[1, 3] = 1.95
    instances = [
        sf.InstanceDesc(mesh_id=0, matrix=np.eye(4, dtype=np.float32)),
        sf.InstanceDesc(mesh_id=1, matrix=m_light, light_id=0, linst_id=0)]
    rng = np.random.default_rng(SEED)
    for _ in range(N_INSTANCES):
        a, b = rng.uniform(0, 2 * np.pi, 2)
        ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]])
        rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                       [0, np.sin(b), np.cos(b)]])
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = ry @ rx @ np.diag(rng.uniform(0.18, 0.42, 3))
        M[:3, 3] = rng.uniform([-1.5, -1.6, -1.5], [1.5, 0.9, 1.5])
        instances.append(sf.InstanceDesc(mesh_id=2, matrix=M))
    cam = sf.CameraDesc()
    cam.position = np.array([0, 0, 5.6], np.float32)
    cam.look_at = np.zeros(3, np.float32)
    return sf.SceneDesc(
        lib_dir="", textures={}, materials=materials, lights={0: light},
        camera=cam,
        settings=sf.RenderSettings(width=width, height=height,
                                   trace_depth=DEPTH),
        meshes={0: mesh_of(walls), 1: make_rect_mesh(0.5, 0.5, 3),
                2: mesh_of(ball)},
        mesh_light_id={}, instances=instances,
        light_instances=[sf.LightInstanceDesc(light_id=0, matrix=m_light)])


def kernel_rows(label, replaces, recs, counts, inst: bool) -> list:
    """The "kernels" records of one main path: one row per hit mode, times
    summed over the wavefronts named in the row."""
    rows = []
    for mode, key, what in (("closest", "B3" if inst else "B1", "closest hit"),
                            ("any", "B3" if inst else "B2", "any hit")):
        r = recs[mode]
        count = counts[("inst_" if inst else "") + mode + "_launches"]
        rows.append({
            "name": f"{key} cluster traversal, {what}, {label} "
                    f"({' + '.join(x[0] for x in r)})",
            "route": "cuda",
            "source": "hydracore_tpu_torch/csrc/traverse_cluster.cu",
            "replaces": replaces,
            "launches": count,
            "max_abs_err": max(x[5] for x in r),
            "ms": sum(x[1] for x in r),
            "plain_ms": sum(x[2] for x in r),
            "bound_ms": sum(x[3] for x in r),
            "bound_by": r[0][4],
            "library_ms": None,
        })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from hydracore_tpu_torch.integrators import pt
    from hydracore_tpu_torch.ops import traverse_cluster as tc
    from hydracore_tpu_torch.scene.procedural import bench_builder, bench_scene
    from hydracore_tpu_torch.scene.scene import assemble
    from hydracore_tpu_torch.utils import build

    dev = torch.device("cuda")
    card = gpu_name_power()
    t_start = time.time()

    # ---- phase 1: build every native source, compilers in parallel
    t0 = time.time()
    srcs = ["traverse_cluster.cu", "bvh_builder.cpp"]
    started = {s: build.start_build(s) for s in srcs}
    for s in srcs:
        build.finish_build(s, started[s])
    tc._kernel_lib()
    log(f"phase 1 build: {time.time() - t0:.2f} s ({', '.join(srcs)})")

    # ---- phase 2-5: the flat pool (B1, B2)
    t0 = time.time()
    host_scene = bench_scene(WIDTH, HEIGHT, DEPTH)
    scene = host_scene.to(dev)
    log(f"phase 2 flat scene: {host_scene.num_triangles} triangles, "
        f"{real_boxes(host_scene).shape[1]} clusters (Cp "
        f"{host_scene.cl_tris.shape[0]}), built in {time.time() - t0:.2f} s")
    flat_recs = check_kernels("phase 3 flat", tc, scene,
                              wavefronts(pt, tc, scene), card)
    log(f"phase 4 flat: {N_PASS} passes (4 before the instanced and "
        "partitioned paths joined the run)")
    flat_counts = drive_main_path("phase 4 flat", pt, tc, scene, card,
                                  {"closest_launches", "any_launches"})
    card_vs_cpu("phase 4 flat", pt, bench_scene(64, 64, DEPTH))
    profile_pass(pt, scene, card, "phase 5 flat")
    del scene

    # ---- phase 6: the instanced layout (B3), assembled from a SceneDesc
    t0 = time.time()
    desc = instanced_desc(WIDTH, HEIGHT)
    host_inst = assemble(desc, instancing="auto")
    if not host_inst.settings.has_inst:
        raise AssertionError("auto-instancing did not engage")
    flat_tris = sum(desc.meshes[i.mesh_id].num_triangles for i in desc.instances)
    n_iclusters = real_boxes(host_inst).shape[1]
    log(f"phase 6 instanced scene: {host_inst.num_triangles} triangles stored "
        f"against {flat_tris} flattened, {host_inst.inst_attr.shape[0] - 1} "
        f"instances, {n_iclusters} instance-clusters (Ci "
        f"{host_inst.cl_map.shape[1]}) over a pool of "
        f"{host_inst.cl_tris.shape[0]} blocks, assembled in "
        f"{time.time() - t0:.2f} s")
    if flat_tris <= 400_000:
        raise AssertionError(f"only {flat_tris} flattened triangles")
    inst_scene = host_inst.to(dev)
    inst_recs = check_kernels("phase 6 instanced", tc, inst_scene,
                              wavefronts(pt, tc, inst_scene), card)
    inst_counts = drive_main_path(
        "phase 6 instanced", pt, tc, inst_scene, card,
        {"inst_closest_launches", "inst_any_launches"})
    profile_pass(pt, inst_scene, card, "phase 6 instanced")
    del inst_scene
    img_inst = card_vs_cpu("phase 6 instanced", pt,
                           assemble(desc, 64, 64, instancing="auto"))
    t0 = time.time()
    flattened = assemble(desc, 64, 64, instancing="off")
    img_flat = pt.render(flattened, spp=8, seed=SEED, device="cuda").cpu()
    mse = float(((img_inst - img_flat) ** 2).mean())
    log(f"phase 6 instanced 64x64 8 spp: MSE {mse:.3e} against the flattened "
        f"assembly ({flattened.num_triangles} triangles, pool "
        f"{tuple(flattened.cl_tris.shape[:-2])}, assembled and rendered in "
        f"{time.time() - t0:.2f} s)")
    if not mse < 1e-4:
        raise AssertionError(f"instanced vs flattened image: MSE {mse}")
    del flattened

    # ---- phase 7: the partitioned pool (B1, B2 through the chunk loop)
    t0 = time.time()
    big = bench_builder(n_seg=450, n_ring=225)
    host_part = bench_scene(WIDTH, HEIGHT, DEPTH, builder=big)
    P = host_part.cl_tris.shape[0] if host_part.cl_tris.dim() == 4 else 1
    log(f"phase 7 partitioned scene: {host_part.num_triangles} triangles, "
        f"{real_boxes(host_part).shape[1]} clusters in {P} chunks of "
        f"{host_part.cl_tris.shape[-3]}, built in {time.time() - t0:.2f} s")
    if P < 3:
        raise AssertionError(f"the pool has {P} chunks, expected >= 3")
    part_scene = host_part.to(dev)
    repacked = bench_scene(WIDTH, HEIGHT, DEPTH, builder=big,
                           part_cap=1 << 20).to(dev)
    if repacked.cl_tris.dim() != 3:
        raise AssertionError("the re-packed pool is not flat")
    part_recs = check_kernels("phase 7 partitioned", tc, part_scene,
                              wavefronts(pt, tc, part_scene), card,
                              flat_scene=repacked)
    del repacked
    part_counts = drive_main_path("phase 7 partitioned", pt, tc, part_scene,
                                  card, {"closest_launches", "any_launches"})
    profile_pass(pt, part_scene, card, "phase 7 partitioned")
    log(f"all phases: {time.time() - t_start:.1f} s")

    at = "hydracore_tpu/ops/traverse_cluster.py"
    rows = (kernel_rows("flat pool Cp 384", f"{at}:576", flat_recs,
                        flat_counts, False)
            + kernel_rows(f"instanced Ci {host_inst.cl_map.shape[1]}",
                          f"{at}:394", inst_recs, inst_counts, True)
            + kernel_rows(f"{P} chunks of 1024", f"{at}:663", part_recs,
                          part_counts, False))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
