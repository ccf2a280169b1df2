"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's native code from the checkout (csrc/ -> the git-ignored
hydracore_tpu_torch/_build/, the compilers started together), then drives
four main paths of the MIS+NEE path tracer, and a textured fifth (phase
14), render_passes at 1024x1024, depth 5, seed 777, each through its
kernels:
  flat         the procedural bench_scene (26,252 triangles, one flat
               cluster pool) through B1 (closest hit) and B2 (any hit), a
               two-level walk over groups of clusters (the positions and
               Woop blocks a ray block walks are logged per wavefront);
  instanced    a cornell box holding 24 transformed instances of one
               25,280-triangle mesh, assembled from a SceneDesc with
               instancing="auto" (over 400,000 flattened triangles), through
               B3 in both hit modes (a two-level walk: the positions and
               Woop blocks a ray block walks are logged per wavefront);
  partitioned  bench_scene with its large sphere at 201,600 triangles (a
               pool of three 1024-cluster chunks) through B1 and B2, whose
               groups of every chunk form one front-to-back order (logged
               as for the flat pool);
  packet       the same 202,572 triangles built with traversal="packet":
               warp packets over the 8-wide BVH through B4 in both hit
               modes, the wavefronts unsorted as that route leaves them.
For each path it first holds the kernels against their plain PyTorch twin
on the card at the path's shapes (primary, bounce and shadow wavefronts of
2^18 rays) and times both, then resets the launch counters, renders, and
checks the counters (and, for B4, that no packet reached MAX_VISITS). B4
also runs in its profiling instantiation on the unsorted wavefronts (the
cycles and the node and leaf entries of each packet, each SM's span and
tail, the CTAs an SM holds), and cuobjdump reports the registers, spills
and SASS instructions of each B4 instantiation. The
flat and the instanced scene are also rendered at 64x64, 8 spp on the card
(kernels) and on the CPU (twins) and compared; the instanced one also
against the flattened assembly of the same SceneDesc; the chunked kernels
also against the flat-pool kernels on the same clusters; B4 also against
the chunked B1/B2 on the very rays those got; the flat scene also through
B4 against the CPU twins and the cluster route's image. The two plain
routes run too: the wide-BVH loop on the packet path's scene at 256x256 and
the dense route on the golden cornell box, each card against CPU. One pass
of each kernel path runs under torch.profiler.
Phase 12 is the kernel lab (hydracore_tpu_torch/tools/): the kernels of
tools T7 (row gathers, S 4096, R 262,144, 16 iterations), T6 (ten probes
on (64, 128)), T5 (sub-visits, G 512, V 64, C 384) and T1 (the cluster
kernel's cost split on bench_scene at 512x512, every variant and B1 as
"full") held against their plain versions on the card at the tools' own
sizes and timed with them (T7 also against one embedding_bag call, T6's
probes where one PyTorch call computes them against that call), then each
tool's main() run with its launch counters set to 0 just before and read
just after; main() times each lab kernel as the mean of a CUDA graph of
its calls, without the host's issue time.
Phase 13 is the lab's traversal prototypes, each tool's main() first, with
its launch counter set to 0 just before and read just after, and its
outputs and times then used by the checks: T2 (the dense cluster
traversal over synthetic clusters, 262,144 rays, C 256) in the tool's eight
jobs, kernel against plain version bit for bit, the MXU job without a hit,
and once more with random plane columns, where the Plucker test must hit;
T3 and T4 (packets of 128 and 1024 rays) on bench_scene at 512x512 with the
tools' coherent and incoherent rays, each against its plain version on
16,384 rays from the middle of the set (t, u, v, slot, visits equal), the
packets at MAX_VISITS logged; B4 on the same rays against both (hit masks,
t on hits, slots on >= 99.9%), the three packet sizes timed side by side
against one bound.
Phase 14 is textured shading and alpha shadows: a SceneDesc written with
its texture files and an IES profile (textured_desc: bench_builder's
geometry without the right wall, 512 opacity-mapped quads, a tiled 1024^2
floor texture, a height map baked to a normal map, a reflection texture, a
mask blend and a two-level blend tree, a 2048x1024 sky image with a
camera-projected back plate, an IES point light) through assemble; B1 on
its wavefronts and B2 over the opaque shadow pool on its shadow wavefront
against their twins, flat and in chunks of 128 clusters, rays onto the
alpha triangles hitting the full pool and never the opaque one; the dense
alpha layer timed; the main path (the opaque-pool counter > 0, B2 over the
full pool 0) flat and chunked, a profile; 64x64 card images against the CPU
twins on the cluster and the packet route. The 64x64 checks of phases 4,
6, 9 and 11 run at depth CHECK_DEPTH, phase 14's at the scene's depth.
Any failed check raises: the script then exits non-zero and prints no
result line. On success the last line is the JSON result
{"ok": true, "device": {...}}; the line before it the card's name and power
limit; before that a "kernels" JSON line.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from hydracore_tpu_torch.utils import lab  # noqa: E402

SEED = 777
WIDTH = HEIGHT = 1024
DEPTH = 5
N_PASS = 2
N_INSTANCES = 24
# depth of the 64x64 card-against-CPU images of phases 4, 6, 9 and 11: the
# CPU twins' render there costs the script more time than anything else.
# Russian roulette starts at depth 3, so these images do not reach it;
# phase 14's, on the cluster and packet routes, stay at DEPTH and do
CHECK_DEPTH = 3
# operations the traversal needs: a ray-box slab test (6 mul-sub pairs,
# 10 min/max, 2 compares), one lane's Woop test (the w row dot products,
# the divide and the t range test; u, v only for the rare candidates), and
# moving a ray into an instance's local space once per instance-cluster it
# enters (18 multiplies and 15 adds)
OPS_BOX = 24
OPS_LANE = 20
OPS_INST = 33
# one Moller-Trumbore of the packet kernel: two cross products (18), four dot
# products (20), the divide, the subtraction of v0 (3), three scalings (3)
# and the six comparisons
OPS_TRI = 51


def log(msg: str) -> None:
    print(msg, flush=True)


def real_boxes(scene):
    """(8, C) boxes of the scene's real clusters (instance-clusters of an
    instanced scene), the chunks of a partitioned pool side by side."""
    b = scene.cl_bounds
    if b.dim() == 3:
        b = b.permute(1, 0, 2).reshape(8, -1)
    return b[:, b[0] < 1e29]


def needed_visits(scene, rays, t_end, lanes=None) -> int:
    """Ray-cluster pairs whose box a ray enters before its final t: the
    Woop blocks this run's data needs, whatever walks them. With `lanes`
    (one count per real cluster, real_boxes' order) each pair counts that
    many lanes."""
    from hydracore_tpu_torch.ops.intersect import safe_inv
    from hydracore_tpu_torch.ops.traverse_cluster import BIG

    flat = rays.reshape(-1, 8)
    act = flat[:, 7] > 0
    b = real_boxes(scene)
    visits = 0
    step = max(1024, (1 << 26) // max(b.shape[1], 1))
    for s in range(0, flat.shape[0], step):
        f = flat[s:s + step]
        inv = safe_inv(f[:, 3:6])
        ta = (b[None, 0:3] - f[:, 0:3, None]) * inv[:, :, None]
        tb = (b[None, 3:6] - f[:, 0:3, None]) * inv[:, :, None]
        tn = torch.minimum(ta, tb).amax(dim=1)
        tf = torch.maximum(ta, tb).amin(dim=1)
        te = t_end[s:s + step]
        te = torch.where(te <= -BIG * 0.5, f[:, 6], te)[:, None]
        hit = (tf >= tn.clamp(min=0)) & (tn < te) & act[s:s + step, None]
        visits += int(hit.sum() if lanes is None
                      else (hit.to(torch.int64) * lanes).sum())
    return visits


def two_level_box_tests(scene, rays, t_end) -> int:
    """Box tests the two-level walk needs: one per active ray and box of the
    upper level (an instanced scene's instances, any other's groups of
    clusters), and one per active ray and member (instance-cluster,
    cluster) of each upper box the ray enters before its final t."""
    from hydracore_tpu_torch.ops.intersect import safe_inv
    from hydracore_tpu_torch.ops.traverse_cluster import BIG, slab_enters

    boxes, start = scene.lvl_bounds, scene.lvl_start
    flat = rays.reshape(-1, 8)
    act = flat[:, 7] > 0
    te = torch.where(t_end <= -BIG * 0.5, flat[:, 6], t_end)
    ent = slab_enters(flat[:, 0:3], safe_inv(flat[:, 3:6]), boxes,
                      te) & act[:, None]
    sizes = (start[1:] - start[:-1]).to(torch.int64)
    return (int(act.sum()) * sizes.numel()
            + int((ent.to(torch.int64) * sizes).sum()))


def block_visits(scene, rays, t_end) -> torch.Tensor:
    """Woop blocks each ray block needs: per block the real clusters some
    active ray of it enters before its final t (an occluded ray: before its
    limit). A walk that stages a cluster for the whole block stages at
    least these. Returns (G,) int64."""
    from hydracore_tpu_torch.ops.intersect import safe_inv
    from hydracore_tpu_torch.ops.traverse_cluster import BIG, slab_enters

    G, RB, _ = rays.shape
    flat = rays.reshape(-1, 8)
    te = torch.where(t_end <= -BIG * 0.5, flat[:, 6], t_end)
    b = real_boxes(scene)
    out = torch.zeros(G, dtype=torch.int64, device=rays.device)
    step = max(1, (1 << 24) // (b.shape[1] * RB))  # blocks a step
    for g in range(0, G, step):
        f = flat[g * RB:(g + step) * RB]
        ent = slab_enters(f[:, 0:3], safe_inv(f[:, 3:6]), b,
                          te[g * RB:(g + step) * RB]) & (f[:, 7:8] > 0)
        out[g:g + step] = ent.reshape(-1, RB, b.shape[1]).any(dim=1).sum(dim=1)
    return out


def cluster_bound_ms(scene, rays, t_end, lanes=None) -> tuple[float, str]:
    """The least time the card could take: rays in, t and slot out and the
    arrays the kernel reads (the pool and its upper level) once, over the
    memory rate; over the f32 rate the box tests of the two-level walk
    (two_level_box_tests) and Woop lanes (and for an instanced scene the
    ray's move into local space) for every cluster a ray enters before its
    final t: all 128 lanes, or the cluster's count in `lanes` (the lanes
    that can hit, live_lanes)."""
    from hydracore_tpu_torch.ops.traverse_cluster import LEVEL_TABLES

    n = rays.shape[0] * rays.shape[1]
    inst = scene.cl_map is not None
    pool = [scene.cl_tris, scene.cl_map, scene.inst_woop,
            *(getattr(scene, k) for k in LEVEL_TABLES)]
    bytes_ = n * 8 * 4 + n * 8 + sum(x.numel() * x.element_size()
                                     for x in pool if x is not None)
    visits = needed_visits(scene, rays, t_end)
    lane_visits = (visits * 128 if lanes is None
                   else needed_visits(scene, rays, t_end, lanes))
    ops = (two_level_box_tests(scene, rays, t_end) * OPS_BOX
           + lane_visits * OPS_LANE + visits * (OPS_INST if inst else 0))
    return lab.bound_ms(bytes_, ops)


def profile_pass(pt, scene, card: str, tag: str) -> None:
    """torch.profiler over one 1024x1024 pass: wall time, device busy time
    and the kernels that take it, largest first. The profiler records the
    device's activity alone, and its raw kineto events are summed here by
    name: recording the host's events and reading key_averages() give the
    same device times and take many times the pass's own wall time."""
    from torch.profiler import ProfilerActivity, profile

    t_all = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        pt.render_passes(scene, 200, SEED, n_pass=1, max_depth=DEPTH,
                         device=scene.tri_attr.device)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            k = by_name.setdefault(e.name(), [0.0, 0])
            k[0] += e.duration_ns() / 1e6
            k[1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    if busy <= 0.0:
        log(f"{tag} profile: device time not measured (no CUDA events)")
        return
    log(f"{tag} profile, one pass: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(n for _, n in by_name.values())} kernel launches [{card}] "
        f"(the profiler's own time {time.time() - t_all - wall / 1e3:.2f} s)")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"{tag}   {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:5d} {name[:90]}")


def wavefronts(pt, scene, sort: bool = True, light_row: int = 0):
    """The main path's three kinds of wavefront on `scene`, 2^18 rays each:
    every 4th primary ray of the frame in Morton order (spread over the
    whole image), cosine-sampled bounce rays off their hit points and
    shadow rays to uniform points on the rect light (light row
    `light_row`). With
    `sort` the last two come in coherence order, as the path tracer sends
    them to the cluster kernels; without, in the primaries' order with the
    dead rays in place, as it sends them to every other route. Returns
    [(name, origins, directions, t_max, active, any_hit_mode)]."""
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
    everyone = torch.arange(ray_o.shape[0], device=dev)
    perm = coherence_order(scene, bo, wi, hit) if sort else everyone
    bounce_o, bounce_d, bounce_act = bo[perm], wi[perm], hit[perm]
    lt = scene.lights
    k = light_row
    lp = (lt.pos[k] + (2 * rnd[:, 2:3] - 1) * lt.vx[k]
          + (2 * rnd[:, 3:4] - 1) * lt.vy[k])
    to_l = lp - pos
    dist = to_l.norm(dim=-1)
    sd = to_l / dist[:, None].clamp(min=1e-12)
    so = offs_ray_pos(pos, ngs, sd)
    perm = coherence_order(scene, so, sd, hit) if sort else everyone
    sh_o, sh_d, sh_t, sh_act = so[perm], sd[perm], dist[perm] * 0.995, hit[perm]
    return [("primary", ray_o, ray_d, 1e30, None, False),
            ("bounce", bounce_o, bounce_d, 1e30, bounce_act, False),
            ("shadow", sh_o, sh_d, sh_t, sh_act, True)]


def cluster_cases(tc, raw):
    """Wavefronts packed into the cluster kernels' ray blocks:
    [(name, ray blocks, any_hit_mode)]."""
    return [(name, tc._to_blocks(o, d, t_max, act, tc.R_BLK_BOUNCE
                                 if name == "bounce" else tc.R_BLK)[0], any_hit)
            for name, o, d, t_max, act, any_hit in raw]


def check_kernels(tag, tc, scene, cases, card, flat_scene=None) -> dict:
    """Hold the kernel against its twin on every wavefront of `cases`
    (equal hit masks, slots equal >= 0.999, t rel err <= 1e-5, occlusion
    agreement >= 0.9999), optionally against the flat-pool kernel on
    `flat_scene` (the same clusters re-packed flat: equal hit masks, t and
    triangle equal >= 0.999), and time kernel and twin. Returns
    {"closest": [...], "any": [...]} of (name, ms, plain_ms, bound_ms,
    bound_by, max_abs_err) records."""
    pool = tc.scene_pool(scene)
    # the twin walks every cluster: it takes no level of the two-level walk
    twin_pool = {k: v for k, v in pool.items() if k not in tc.LEVEL_TABLES}
    out = {"closest": [], "any": []}
    for name, rays, any_hit_mode in cases:
        n_rays = rays.shape[0] * rays.shape[1]
        tk, sk = tc.cluster_traverse(rays, any_hit_mode=any_hit_mode, **pool)
        tt, stw = tc.cluster_traverse_plain(rays, any_hit_mode=any_hit_mode,
                                            **twin_pool)
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
        # what the upper level's cull leaves of a walk over every cluster
        # (instance-cluster): at most (each ray's t limit) and at least (its
        # final t; an occluded ray adds nothing)
        def walk(t=None):
            return tc.walk_positions(rays, pool, t).float()
        what = (f"{int(scene.lvl_start[-1])} clusters under "
                f"{scene.lvl_start.numel() - 1} upper boxes (a walk over "
                f"every position: {scene.cl_bounds_oct.numel() // 64})")
        most, least = walk(), walk(tk.reshape(-1))
        visits = block_visits(scene, rays, tk.reshape(-1)).float()
        log(f"{tag} {name}: positions a block walks, of {what}: at most "
            f"mean {float(most.mean()):.1f}, largest {int(most.max())}; at "
            f"least mean {float(least.mean()):.1f}, largest "
            f"{int(least.max())}; Woop blocks a block needs: mean "
            f"{float(visits.mean()):.1f}, largest {int(visits.max())}")
        if flat_scene is not None:
            tf, sf = tc.cluster_traverse(rays, any_hit_mode=any_hit_mode,
                                         **tc.scene_pool(flat_scene))
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
        ms = lab.time_ms(lambda: tc.cluster_traverse(
            rays, any_hit_mode=any_hit_mode, **pool), 20, rays.device)
        plain = lab.time_ms(lambda: tc.cluster_traverse_plain(
            rays, any_hit_mode=any_hit_mode, **twin_pool), 1, rays.device)
        bms, by = cluster_bound_ms(scene, rays, tk.reshape(-1))
        log(f"{tag} {name}: kernel {ms:.4f} ms, twin {plain:.4f} ms, "
            f"bound {bms:.5f} ms ({by}) [{card}]")
        out["any" if any_hit_mode else "closest"].append(
            (name, ms, plain, bms, by, err))
    return out


def group_sizes(tag, tc, scene, cases, card, sizes=(8, 16, 32)) -> None:
    """B1/B2 over the group levels of `sizes` clusters a group
    (bvh/clusters.py:group_tables) on every wavefront of `cases`: each
    level's hit masks equal the scene's own level's (the cull is exact),
    and each is timed, so the choice of CL_GROUP is a measured one."""
    from hydracore_tpu_torch.bvh.clusters import group_tables

    pool = tc.scene_pool(scene)
    bl, perm = scene.cl_bounds.cpu().numpy(), scene.cl_oct_perm.cpu().numpy()
    levels = {g: {k: torch.as_tensor(v).to(scene.cl_tris.device)
                  for k, v in group_tables(bl, perm, g).items()}
              for g in sizes}
    for name, rays, any_hit_mode in cases:
        _, s_own = tc.cluster_traverse(rays, any_hit_mode=any_hit_mode, **pool)
        times = []
        for g in sizes:
            p = {**pool, **levels[g]}
            _, s_g = tc.cluster_traverse(rays, any_hit_mode=any_hit_mode, **p)
            if not torch.equal(s_own >= 0, s_g >= 0):
                raise AssertionError(f"{tag} {name}: groups of {g} change "
                                     "the hit masks")
            ms = lab.time_ms(lambda: tc.cluster_traverse(
                rays, any_hit_mode=any_hit_mode, **p), 20, rays.device)
            times.append(f"{g} ({levels[g]['lvl_bounds'].shape[1]} groups) "
                         f"{ms:.4f}")
        log(f"{tag} {name}: kernel over groups of {', '.join(times)} ms "
            f"[{card}]")


COUNTERS = ("closest_launches", "any_launches", "opaque_any_launches",
            "inst_closest_launches", "inst_any_launches",
            "pkt_closest_launches", "pkt_any_launches")


def launch_counts(tc, tp) -> dict:
    """Every wrapper's launch count: B1, B2, B2 over the opaque shadow pool,
    B3 (closest, any), B4 (closest, any)."""
    out = {k: getattr(tc, k) for k in COUNTERS[:5]}
    out.update(pkt_closest_launches=tp.closest_launches,
               pkt_any_launches=tp.any_launches)
    return out


def drive_main_path(tag, pt, tc, tp, scene, card, expect: set,
                    width: int = WIDTH, height: int = HEIGHT,
                    n_pass: int = N_PASS) -> dict:
    """One warm-up pass, then n_pass passes with the launch counters set to
    0 just before and read just after. `expect` names the counters that must
    be > 0; every other counter must stay 0. No packet of B4 may reach
    MAX_VISITS."""
    dev = scene.tri_attr.device
    pt.render_passes(scene, 100, SEED, n_pass=1, max_depth=DEPTH, device=dev)
    torch.cuda.synchronize()
    tc.reset_launch_counts()
    tp.reset_launch_counts()
    t0 = time.time()
    img, rays_traced = pt.render_passes(scene, 0, SEED, n_pass=n_pass,
                                        max_depth=DEPTH, device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = launch_counts(tc, tp)
    rays_traced = int(rays_traced)
    log(f"{tag} main path: launches {counts}")
    if not bool(torch.isfinite(img).all()) or float(img.sum()) <= 0.0:
        raise AssertionError(f"{tag}: image is not finite and non-zero")
    if tuple(img.shape) != (height, width, 3):
        raise AssertionError(f"{tag}: image shape {tuple(img.shape)}")
    for k, v in counts.items():
        if (v > 0) != (k in expect):
            raise AssertionError(f"{tag}: launch counts {counts}, expected "
                                 f"exactly {sorted(expect)} to be non-zero")
    if counts["pkt_closest_launches"] > 0:
        # the same passes once more, untimed, with every launch's visit
        # counts read through the wrapper's hook
        peaks = []
        tp.visits_hook = lambda n: peaks.append(n.max())
        try:
            pt.render_passes(scene, 0, SEED, n_pass=n_pass, max_depth=DEPTH,
                             device=dev)
        finally:
            tp.visits_hook = None
        peak = max(int(p) for p in peaks)
        log(f"{tag} main path: the busiest packet of {len(peaks)} launches "
            f"popped {peak} entries (MAX_VISITS {tp.MAX_VISITS})")
        if not 0 < peak < tp.MAX_VISITS:
            raise AssertionError(f"{tag}: a packet reached MAX_VISITS ({peak})")
    samples = n_pass * width * height
    log(f"{tag} main path: {width}x{height} depth {DEPTH} {n_pass} passes in "
        f"{dt:.3f} s: {samples / dt / 1e6:.4f} Msamples/s, "
        f"{rays_traced / dt / 1e6:.4f} Mrays/s ({rays_traced} rays) [{card}]")
    return counts


def pixels_close(a, b) -> float:
    return float(((a - b).abs().amax(dim=-1) <= 1e-3).float().mean())


def card_vs_cpu(tag, pt, small, spp: int = 8, max_depth=None) -> torch.Tensor:
    """64x64, `spp` samples (to max_depth, else the scene's depth) on the
    card against the CPU (the kernels' twins, or the same plain code):
    >= 99% of pixels within 1e-3. Returns the card's image."""
    img_gpu = pt.render(small, spp=spp, seed=SEED, max_depth=max_depth,
                        device="cuda").cpu()
    t0 = time.time()
    img_cpu = pt.render(small, spp=spp, seed=SEED, max_depth=max_depth,
                        device="cpu")
    close = pixels_close(img_gpu, img_cpu)
    depth = max_depth or small.settings.trace_depth
    log(f"{tag} 64x64 {spp} spp depth {depth}: pixels within 1e-3 of the "
        f"CPU's image: {close:.4f} (the CPU's render {time.time() - t0:.2f} s)")
    if close < 0.99:
        raise AssertionError(f"{tag}: card vs CPU image: {close} of pixels agree")
    return img_gpu


def packet_needs(scene, flat, t_end) -> tuple[int, int, int, int]:
    """(node entries, leaf entries, node rows, leaf rows): for every active
    ray the nodes and the leaves of the 8-wide BVH whose box it enters before
    its final t, found by a sweep down the tree over (ray, node) pairs, and
    how many different rows of pkt_nodes and pkt_tris those entries read.
    The counts are the rays' own: they do not depend on what walks the tree
    or on the packet a ray rides in."""
    from hydracore_tpu_torch.bvh.wide import EMPTY_PAYLOAD
    from hydracore_tpu_torch.ops.intersect import safe_inv

    nodes = scene.pkt_nodes.view(-1, 8, 16)
    pay = scene.pkt_nodes.view(torch.int32).view(-1, 8, 16)[:, :, 6]
    node_read = torch.zeros(scene.pkt_nodes.shape[0], dtype=torch.bool,
                            device=flat.device)
    leaf_read = torch.zeros(scene.pkt_tris.shape[0], dtype=torch.bool,
                            device=flat.device)
    act = flat[:, 7] > 0
    te = torch.minimum(t_end, flat[:, 6])
    inv = safe_inv(flat[:, 3:6])
    rays = torch.nonzero(act).flatten()
    at = torch.zeros_like(rays)
    n_nodes = n_leaves = 0
    step = 1 << 20
    while rays.numel() > 0:
        n_nodes += rays.numel()
        node_read[at] = True
        nxt_r, nxt_n = [], []
        for s in range(0, rays.numel(), step):
            r, n = rays[s:s + step], at[s:s + step]
            rec, p = nodes[n], pay[n]
            o, i = flat[r, 0:3][:, None, :], inv[r][:, None, :]
            ta = (rec[:, :, 0:3] - o) * i
            tb = (rec[:, :, 3:6] - o) * i
            tn = torch.minimum(ta, tb).amax(dim=2)
            tf = torch.maximum(ta, tb).amin(dim=2)
            hit = (tf >= tn.clamp(min=0)) & (tn < te[r][:, None]) \
                & (p != EMPTY_PAYLOAD)
            leaf = hit & (p < 0)
            n_leaves += int(leaf.sum())
            leaf_read[(-p[leaf] - 1).long()] = True
            k, c = torch.nonzero(hit & (p >= 0), as_tuple=True)
            nxt_r.append(r[k])
            nxt_n.append(p[k, c].long())
        rays, at = torch.cat(nxt_r), torch.cat(nxt_n)
    return n_nodes, n_leaves, int(node_read.sum()), int(leaf_read.sum())


def packet_bound_ms(scene, packets, t_end) -> tuple[float, str, str]:
    """The least time the card could take for B4's work on these rays. Bytes
    over the memory rate: rays in (32 bytes), t, u, v and slot out (16), a
    visit count per packet (4), and once each the rows of 512 bytes of
    pkt_nodes and pkt_tris that some ray needs. Operations over the f32
    rate: 8 slab tests for every node and 8 Moller-Trumbore tests for every
    leaf a ray needs. A ray needs the nodes and leaves it enters before its
    final t, for bytes and operations alike. Returns (ms, bound by, both
    parts in words)."""
    flat = packets.reshape(-1, 8)
    n = flat.shape[0]
    n_nodes, n_leaves, node_rows, leaf_rows = packet_needs(scene, flat, t_end)
    bytes_ = n * 32 + n * 16 + packets.shape[0] * 4 \
        + (node_rows + leaf_rows) * 512
    ops = n_nodes * 8 * OPS_BOX + n_leaves * 8 * OPS_TRI
    t_bytes = bytes_ / lab.PEAK_BYTES_S * 1e3
    t_ops = ops / lab.PEAK_F32_OPS_S * 1e3
    note = (f"bytes {t_bytes:.5f} ms for the rays and {node_rows} of "
            f"{scene.pkt_nodes.shape[0]} node rows, {leaf_rows} of "
            f"{scene.pkt_tris.shape[0]} leaf rows; operations {t_ops:.5f} ms "
            f"for {n_nodes} node and {n_leaves} leaf entries of single rays")
    return (t_ops, "operations", note) if t_ops >= t_bytes \
        else (t_bytes, "bytes", note)


def check_packet(tag, tp, scene, raw, card, twin: bool = True) -> dict:
    """Hold B4 against its twin on every wavefront of `raw` (equal hit
    masks, t, u and v equal within 1e-6 absolute, slots equal >= 0.999,
    visit counts equal, no packet at MAX_VISITS) and time kernel and twin.
    Without `twin` only the kernel is run and timed. Returns
    {"closest": [...], "any": [...]} of (name, ms, plain_ms, bound_ms,
    bound_by, max_abs_err) records and the kernel's outputs by name."""
    out = {"closest": [], "any": [], "hits": {}}
    for name, o, d, t_max, act, any_hit in raw:
        packets, R = tp._to_packets(o, d, t_max, act)
        tk, uk, vk, sk, nk = tp.packet_traverse(packets, scene.pkt_nodes,
                                                scene.pkt_tris, any_hit)
        torch.cuda.synchronize()
        peak = int(nk.max())
        hk = sk >= 0
        log(f"{tag} {name}: {R} rays in {packets.shape[0]} packets of "
            f"{tp.PKT}, hits {int(hk.sum())}, entries popped per packet: "
            f"mean {float(nk.float().mean()):.1f}, most {peak} (MAX_VISITS "
            f"{tp.MAX_VISITS})")
        if peak >= tp.MAX_VISITS:
            raise AssertionError(f"{tag} {name}: a packet reached MAX_VISITS")
        if not hk.any():
            raise AssertionError(f"{tag} {name}: no ray hit anything")
        err, plain = 0.0, float("nan")
        if twin:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            tt, ut, vt, st, nt = tp.packet_traverse_plain(
                packets, scene.pkt_nodes, scene.pkt_tris, any_hit)
            b.record()
            torch.cuda.synchronize()
            plain = a.elapsed_time(b)
            if not torch.equal(hk, st >= 0):
                raise AssertionError(f"{tag} {name}: hit masks differ on "
                                     f"{int((hk != (st >= 0)).sum())} rays")
            if not torch.equal(nk, nt):
                raise AssertionError(f"{tag} {name}: visit counts differ on "
                                     f"{int((nk != nt).sum())} packets")
            same = float((sk[hk] == st[hk]).float().mean())
            errs = [float((x[hk] - y[hk]).abs().max())
                    for x, y in ((tk, tt), (uk, ut), (vk, vt))]
            err = max(errs)
            log(f"{tag} {name}: against the twin slots equal on {same:.6f}, "
                f"max abs err t {errs[0]:.3e}, u {errs[1]:.3e}, v {errs[2]:.3e}")
            if same < 0.999 or not err <= 1e-6:
                raise AssertionError(f"{tag} {name}: B4 disagrees with its twin")
        ms = lab.time_ms(lambda: tp.packet_traverse(
            packets, scene.pkt_nodes, scene.pkt_tris, any_hit), 20,
            packets.device)
        bms, by, note = packet_bound_ms(scene, packets, tk.reshape(-1))
        log(f"{tag} {name}: kernel {ms:.4f} ms, twin {plain:.4f} ms (one run), "
            f"bound {bms:.5f} ms ({by}: {note}) [{card}]")
        out["any" if any_hit else "closest"].append(
            (name, ms, plain, bms, by, err))
        out["hits"][name] = (tk.reshape(-1)[:R], sk.reshape(-1)[:R])
    return out


def packet_profile(tag, tp, scene, raw, card) -> None:
    """B4's profiling instantiation on every wavefront of `raw`: its outputs
    must equal the plain instantiation's (t, u, v, slot, visits) and its
    node + leaf entries the visit counts. Logs per packet the cycles of its
    walk and the node and leaf entries it popped (mean, largest), and per SM
    the cycles from its first packet's start to its last packet's end (the
    SM's span) and from its first packet's end to its last packet's end
    (the SM's tail), with the CTAs an SM holds."""
    for name, o, d, t_max, act, any_hit in raw:
        packets, _ = tp._to_packets(o, d, t_max, act)
        prof = torch.zeros((packets.shape[0], 5), dtype=torch.int64,
                           device=packets.device)
        plain = tp.packet_traverse(packets, scene.pkt_nodes, scene.pkt_tris,
                                   any_hit)
        prof_out = tp.packet_traverse(packets, scene.pkt_nodes,
                                      scene.pkt_tris, any_hit, profile=prof)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(plain, prof_out)):
            raise AssertionError(f"{tag} {name}: the profiling instantiation "
                                 "differs from the plain one")
        start, end, sm, n_node, n_leaf = prof.unbind(dim=1)
        if not torch.equal(n_node + n_leaf, plain[4].long()):
            raise AssertionError(f"{tag} {name}: node + leaf entries differ "
                                 "from the visit counts")
        cyc = (end - start).double()
        n_sm = int(sm.max()) + 1
        span_lo = torch.full((n_sm,), 2**62, dtype=torch.int64,
                             device=sm.device).scatter_reduce(
            0, sm, start, "amin")
        first_end = torch.full_like(span_lo, 2**62).scatter_reduce(
            0, sm, end, "amin")
        last_end = torch.zeros_like(span_lo).scatter_reduce(0, sm, end, "amax")
        used = last_end > 0
        span = (last_end - span_lo)[used].double()
        tail = (last_end - first_end)[used].double()
        busiest = int(plain[4].argmax())
        log(f"{tag} {name} profile: cycles a packet mean {float(cyc.mean()):.0f}"
            f", largest {int(cyc.max())} (the busiest packet by entries "
            f"{int(cyc[busiest])}); node entries mean "
            f"{float(n_node.double().mean()):.1f}, largest {int(n_node.max())}; "
            f"leaf entries mean {float(n_leaf.double().mean()):.1f}, largest "
            f"{int(n_leaf.max())}; {int(used.sum())} SMs: span mean "
            f"{float(span.mean()):.0f}, largest {int(span.max())} cycles; tail "
            f"(first packet's end to the last's) mean {float(tail.mean()):.0f}, "
            f"largest {int(tail.max())} cycles; CTAs an SM "
            f"{tp.ctas_per_sm(any_hit)} (profiling {tp.ctas_per_sm(any_hit, True)})"
            f" [{card}]")


SASS_CLASSES = {
    "global loads": ("LDG",), "shared loads": ("LDS",),
    "shared stores": ("STS",), "async copies": ("LDGSTS",),
    "votes and shuffles": ("VOTE", "VOTEU", "SHFL", "REDUX", "MATCH"),
    "f32 arithmetic": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL",
                       "MUFU"),
    "branches": ("BRA", "BSSY", "BSYNC", "WARPSYNC", "CALL"),
}


def kernel_code(tag, src: str) -> None:
    """Registers, spills (the stack frame and local memory), shared memory
    and SASS instructions of every kernel in csrc/`src`'s library, read with
    cuobjdump (-res-usage, -sass). The instructions are counted by class
    over the whole function, and in the loop's node and leaf bodies: the
    code is cut into basic blocks at branch targets and after branches; a
    leaf block holds a Moller-Trumbore's |det| > 1e-12 or t > 1e-5 test
    (FSETP.GT against that constant), a node block 6 or more FMNMX (the
    slab tests) and neither; a body is the address range from its first
    block to its last, in the kernel's own code (up to its last EXIT: the
    out-of-line paths after it, the division's slow path among them, are in
    neither)."""
    from hydracore_tpu_torch.utils import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib_so = build.lib_path(src)
    res = subprocess.run([tool, "-res-usage", lib_so], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    usage = dict(re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", res))
    sass = subprocess.run([tool, "-sass", lib_so], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    for fn, body in re.findall(
            r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        code = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)"
            r"([^;]*);", body)]
        counts = {k: sum(op in v for _, op, _ in code)
                  for k, v in SASS_CLASSES.items()}
        ends = [a for a, op, _ in code if op == "EXIT"]
        own = [c for c in code if c[0] <= max(ends, default=-1)]
        leaders = {0}
        for i, (a, op, rest) in enumerate(own):
            if op in ("BRA", "CALL", "EXIT", "RET", "JMP"):
                if i + 1 < len(own):
                    leaders.add(own[i + 1][0])
                tgt = re.findall(r"0x([0-9a-f]+)", rest)
                if op != "EXIT" and tgt:
                    leaders.add(int(tgt[-1], 16))
        blocks = []
        for a, op, rest in own:
            if a in leaders or not blocks:
                blocks.append([])
            blocks[-1].append((a, op, rest))

        def leafy(b) -> bool:
            return any(op == "FSETP" and rest.startswith(".GT") and
                       re.search(r"e-(13|06)\b", rest) for _, op, rest in b)

        def body_len(pick) -> int:
            addrs = [a for b in blocks if pick(b) for a, _, _ in b]
            if not addrs:
                return 0
            lo, hi = min(addrs), max(addrs)
            return sum(lo <= a <= hi for a, _, _ in own)

        node = body_len(lambda b: not leafy(b)
                        and sum(op == "FMNMX" for _, op, _ in b) >= 6)
        leaf = body_len(leafy)
        short = re.sub(r"Ev.*$", "", re.sub(r"^_ZN\d+_GLOBAL__N_\w+?\d+", "", fn))
        log(f"{tag} code {short}: {usage.get(fn, 'no resource line')}; "
            f"{len(code)} SASS instructions ("
            f"{', '.join(f'{k} {v}' for k, v in counts.items())}); the "
            f"loop's node body {node}, leaf body {leaf} instructions")


def golden_cornell(width: int, height: int, traversal: str = "auto"):
    """The cornell_diffuse recipe of the golden images: 12 triangles, the
    dense route under "auto"."""
    from hydracore_tpu_torch.scene.procedural import SceneBuilder

    b = SceneBuilder()
    m = b.lambert([0.65, 0.65, 0.65])
    b.add_box_interior(2.0, m, m, m, b.lambert([0.7, 0.12, 0.1]),
                       b.lambert([0.12, 0.55, 0.18]))
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [12.0] * 3)
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=width,
                   height=height, trace_depth=4, traversal=traversal)


def mesh_of(builder, sphere_uv: bool = False):
    """A SceneBuilder's triangles as one MeshData, three vertices each; the
    builder's material ids become the mesh's. With sphere_uv the texcoords
    are the lat-long of each vertex normal (SceneBuilder's spheres carry
    none)."""
    from hydracore_tpu_torch.scene.vsgf import MeshData

    tris = builder.tris
    T = len(tris)

    def col(k, w):
        a = np.stack([t[k + j] for t in tris for j in range(3)])
        return np.concatenate([a, np.zeros((3 * T, w - a.shape[1]),
                                           np.float32)], 1)

    norm = col(3, 4)
    uv = col(6, 2)
    if sphere_uv:
        uv = np.stack([0.5 + np.arctan2(norm[:, 0], norm[:, 2]) / (2 * np.pi),
                       np.arccos(np.clip(norm[:, 1], -1, 1)) / np.pi],
                      1).astype(np.float32)
    tang = np.tile(np.array([[1, 0, 0, 0]], np.float32), (3 * T, 1))
    return MeshData(pos=col(0, 4), norm=norm, tang=tang, texcoord=uv,
                    indices=np.arange(3 * T, dtype=np.int32).reshape(T, 3),
                    mat_indices=np.asarray([t[9] for t in tris], np.int32))


def instanced_desc(width: int, height: int):
    """A SceneDesc built in memory: the cornell box and its rect light as
    world geometry (single-use mesh, emitter: both flatten) and
    N_INSTANCES transformed instances (rotation, non-uniform scale,
    translation from SEED) of one sphere mesh of 25,280 triangles,
    tessellated as SceneBuilder.add_sphere does."""
    from hydracore_tpu_torch.scene import statefile as sf
    from hydracore_tpu_torch.scene.procedural import SceneBuilder
    from hydracore_tpu_torch.scene.vsgf import make_rect_mesh

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


# an IES profile written as text: 1000 cd along the axis, falling to 0 at
# 180 degrees, three planes of phi
TEXTURED_IES = """IESNA:LM-63-2002
[TEST] chip_smoke lamp
TILT=NONE
1 1000.0 1.0 5 3 1 2 0.0 0.0 0.0
1.0 1.0 0.0
0.0 45.0 90.0 135.0 180.0
0.0 45.0 90.0
1000.0 800.0 300.0 50.0 0.0
900.0 600.0 250.0 40.0 0.0
700.0 500.0 200.0 30.0 0.0
"""
N_FOLIAGE = 512


def _write_image(path, img) -> int:
    """Write (h, w, 4) as .image4f (float) or .image4ub (bytes, by the
    file's suffix); returns the byte size."""
    h, w = img.shape[:2]
    if path.endswith("image4f"):
        data = img.astype(np.float32).tobytes()
    else:
        data = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(np.array([w, h], np.int32).tobytes() + data)
    return 8 + len(data)


def _textures(rng) -> dict:
    """The textured scene's images, from SEED: name -> (h, w, 4)."""
    def grid(h, w):
        return np.mgrid[0:h, 0:w].astype(np.float32) / np.float32(max(h, w))

    def rgba(rgb):
        out = np.ones(rgb.shape[:2] + (4,), np.float32)
        out[..., :3] = rgb
        return out

    y, x = grid(1024, 1024)
    checker = ((np.floor(x * 16) + np.floor(y * 16)) % 2)[..., None]
    floor = rgba(0.25 + 0.5 * checker * np.array([0.9, 0.8, 0.6])
                 + 0.15 * rng.random((1024, 1024, 1)))
    y, x = grid(256, 256)
    wall = rgba(0.5 + 0.4 * np.stack([np.sin(9 * x), np.cos(7 * y),
                                      np.sin(5 * (x + y))], -1))
    y, x = grid(512, 512)
    height = rgba(np.repeat((0.5 + 0.25 * np.sin(40 * x) * np.sin(30 * y)
                             + 0.1 * rng.random((512, 512)))[..., None], 3, -1))
    y, x = grid(256, 256)
    mask = rgba(np.repeat(((np.sin(25 * x) * np.sin(25 * y)) > 0)[..., None],
                          3, -1) * 0.9 + 0.05)
    y, x = grid(512, 512)
    refl = rgba(0.3 + 0.6 * ((np.floor(x * 12) + np.floor(y * 6)) % 2)[..., None]
                * np.array([1.0, 0.85, 0.6]))
    y, x = grid(256, 256)
    r2 = (x - 0.5) ** 2 + ((y - 0.5) * 1.6) ** 2
    leaf = rgba(np.stack([np.where(r2 < 0.16, 1.0, np.where(r2 < 0.2, 0.5,
                                                            0.0))] * 3, -1))
    v, u = np.mgrid[0:1024, 0:2048].astype(np.float32)
    v, u = v / 1024, u / 2048
    sky = rgba(np.stack([0.4 + 0.6 * v, 0.6 + 0.4 * v, 1.2 - 0.2 * v], -1)
               * (1.0 - 0.5 * v)[..., None])
    sun = ((u - 0.3) ** 2 + (v - 0.25) ** 2) < 4e-4
    sky[sun, :3] = 60.0
    y, x = grid(1024, 1024)
    plate = rgba(np.stack([0.2 + 0.6 * x, 0.3 + 0.5 * y,
                           0.5 + 0.3 * np.sin(20 * x)], -1))
    return {"floor.image4ub": floor, "wall.image4ub": wall,
            "height.image4ub": height, "mask.image4ub": mask,
            "refl.image4ub": refl, "leaf.image4ub": leaf,
            "sky.image4f": sky, "plate.image4ub": plate}


def textured_desc(lib_dir: str, width: int, height: int):
    """A SceneDesc whose texture files and IES profile are written to
    lib_dir: bench_builder's geometry (the cornell box without its right
    wall, so the sky shows, the GGX and the glass sphere, the rect light)
    and N_FOLIAGE opacity-mapped quads. The floor has a 1024^2 diffuse
    texture tiled 4 times (wrap addressing); the back wall a 256^2 diffuse
    texture and a 512^2 height map (baked to a 512^2 normal map), both bound
    with clamp addressing; the GGX sphere a 512^2 reflection texture; the
    left wall a mask blend; the ceiling a two-level blend tree (a Fresnel
    blend over the left wall's mask blend); the quads a 256^2 opacity map.
    Lights: the rect light, a point light with an IES profile and a sky
    with a 2048x1024 .image4f image and a camera-projected 1024^2 back
    plate."""
    from hydracore_tpu_torch.scene import statefile as sf
    from hydracore_tpu_torch.scene.procedural import SceneBuilder
    from hydracore_tpu_torch.scene.vsgf import make_rect_mesh

    rng = np.random.default_rng(SEED)
    textures = {}
    for tid, (name, img) in enumerate(_textures(rng).items(), start=1):
        size = _write_image(os.path.join(lib_dir, name), img)
        textures[tid] = sf.TextureDesc(id=tid, name=name, loc=name, offset=0,
                                       bytesize=size)
    with open(os.path.join(lib_dir, "lamp.ies"), "w") as f:
        f.write(TEXTURED_IES)

    def diffuse(rgb, tex=""):
        return f'<diffuse brdf_type="lambert"><color val="{rgb}"/>{tex}</diffuse>'

    clamp = 'addressing_mode_u="clamp" addressing_mode_v="clamp"'
    mats = {
        0: diffuse("0.8 0.8 0.8", '<texture id="1" type="texref" matrix="4 0 0 '
                   '0 0 4 0 0 0 0 1 0 0 0 0 1"/>'),
        1: diffuse("0.75 0.75 0.75", f'<texture id="2" type="texref" {clamp} '
                   'matrix="1.3 0 0 -0.15 0 1.3 0 -0.15 0 0 1 0 0 0 0 1"/>')
        + '<displacement type="height_bump"><height_map amount="0.6">'
          f'<texture id="3" type="texref" {clamp}/></height_map></displacement>',
        4: diffuse("0.1 0.1 0.1") + '<reflectivity brdf_type="ggx"><color '
           'val="0.8 0.7 0.5"/><glossiness val="0.75"/><texture id="5" '
           'type="texref"/></reflectivity>',
        5: '<transparency><color val="0.95 0.95 0.95"/><glossiness val="1"/>'
           '<ior val="1.5"/></transparency>',
        7: diffuse("0.25 0.55 0.2") + '<opacity><texture id="6" type="texref"/>'
           '</opacity>',
        10: diffuse("0.7 0.12 0.1"),
        11: diffuse("0.2 0.2 0.25") + '<reflectivity brdf_type="ggx"><color '
            'val="0.6 0.6 0.6"/><glossiness val="0.85"/></reflectivity>',
        12: diffuse("0.65 0.65 0.65"),
    }
    materials = {k: ET.fromstring(f'<material id="{k}" type="hydra_material">'
                                  f'{v}</material>') for k, v in mats.items()}
    materials[2] = ET.fromstring(
        '<material id="2" type="hydra_blend" node_top="10" node_bottom="11">'
        '<blend type="mask_blend"><mask><texture id="4" type="texref"/></mask>'
        '</blend></material>')
    materials[3] = ET.fromstring(
        '<material id="3" type="hydra_blend" node_top="2" node_bottom="12">'
        '<blend type="fresnel_blend" fresnel_ior="1.8"/></material>')
    materials[6] = ET.fromstring(
        '<material id="6" type="hydra_material" light_id="0"><emission>'
        '<color val="12 12 12"/><multiplier val="1"/></emission></material>')
    lights = {
        0: ET.fromstring(
            '<light id="0" type="area" shape="rect" distribution="diffuse" '
            'mat_id="6"><size half_length="0.5" half_width="0.5"/><intensity>'
            '<color val="12 12 12"/><multiplier val="1"/></intensity></light>'),
        1: ET.fromstring(
            '<light id="1" type="sky" shape="point"><intensity><color val="1 1 '
            '1"/><multiplier val="1"/><texture id="7" type="texref"/></intensity>'
            '<back mode="camera_mapped" multcolor="1 1 1"><texture id="8" '
            'type="texref"/></back></light>'),
        2: ET.fromstring(
            '<light id="2" type="point" shape="point"><intensity><color val="6 '
            '6 6"/><multiplier val="1"/></intensity><ies data="lamp.ies"/>'
            '</light>'),
    }
    h = 2.0
    walls = SceneBuilder()
    walls.add_rect([0, -h, 0], [h, 0, 0], [0, 0, h], 0, flip=True)  # floor
    walls.add_rect([0, h, 0], [h, 0, 0], [0, 0, h], 3)  # ceiling
    walls.add_rect([0, 0, -h], [h, 0, 0], [0, h, 0], 1)  # back
    walls.add_rect([-h, 0, 0], [0, h, 0], [0, 0, h], 2)  # left; no right wall
    ggx = SceneBuilder()
    ggx.add_sphere([-0.6, -1.1, -0.4], 0.9, 4, n_seg=160, n_ring=80)
    glass = SceneBuilder()
    glass.add_sphere([0.9, -1.5, 0.7], 0.5, 5)
    leaves = SceneBuilder()
    spheres = ((np.array([-0.6, -1.1, -0.4]), 0.9), (np.array([0.9, -1.5, 0.7]),
                                                      0.5))
    while len(leaves.tris) < 2 * N_FOLIAGE:
        c = rng.uniform([-1.6, -1.4, -1.6], [1.6, 1.6, 1.5])
        if any(np.linalg.norm(c - p) < r + 0.3 for p, r in spheres):
            continue
        a = rng.normal(size=(2, 3))
        vx = a[0] / np.linalg.norm(a[0]) * rng.uniform(0.12, 0.2)
        vy = np.cross(a[0], a[1])
        vy = vy / np.linalg.norm(vy) * rng.uniform(0.12, 0.2)
        leaves.add_rect(c, vx, vy, 7)
    m_light = np.eye(4, dtype=np.float32)
    m_light[1, 3] = 1.95
    m_lamp = np.eye(4, dtype=np.float32)
    m_lamp[:3, 3] = [0.8, 1.2, 0.4]
    eye = np.eye(4, dtype=np.float32)
    meshes = {0: mesh_of(walls), 1: mesh_of(ggx, sphere_uv=True),
              2: mesh_of(glass, sphere_uv=True), 3: mesh_of(leaves),
              4: make_rect_mesh(0.5, 0.5, 6)}
    instances = [sf.InstanceDesc(mesh_id=k, matrix=eye) for k in range(4)]
    instances.append(sf.InstanceDesc(mesh_id=4, matrix=m_light, light_id=0,
                                     linst_id=0))
    cam = sf.CameraDesc()
    cam.position = np.array([1.0, 0.3, 5.6], np.float32)
    cam.look_at = np.array([0.6, 0.0, 0.0], np.float32)
    return sf.SceneDesc(
        lib_dir=lib_dir, textures=textures, materials=materials, lights=lights,
        camera=cam,
        settings=sf.RenderSettings(width=width, height=height,
                                   trace_depth=DEPTH),
        meshes=meshes, mesh_light_id={}, instances=instances,
        light_instances=[sf.LightInstanceDesc(light_id=0, matrix=m_light),
                         sf.LightInstanceDesc(light_id=1, matrix=eye),
                         sf.LightInstanceDesc(light_id=2, matrix=m_lamp)])


def live_lanes(scene) -> torch.Tensor:
    """Per real cluster (real_boxes' order) the lanes of the opaque shadow
    pool that can hit: a triangle's lane whose Woop rows are not zeroed."""
    slot = scene.cl_slot_tri.reshape(-1, 128)
    zero = (scene.cl_tris_shadow.reshape(-1, 4, 384) == 0).all(dim=1)
    dead = zero[:, :128] & zero[:, 128:256] & zero[:, 256:]
    b = scene.cl_bounds
    if b.dim() == 3:
        b = b.permute(1, 0, 2).reshape(8, -1)
    return ((slot >= 0) & ~dead).sum(dim=1)[b[0] < 1e29]


def leaf_rays(scene):
    """One ray per alpha triangle, from 0.01 off its centroid along its
    normal towards the centroid, limited to 0.011: only that triangle lies
    in range (the quads keep 0.3 from the spheres and the walls)."""
    tri = scene.alpha_tri9f[:, scene.alpha_tri_id >= 0]
    v0, e1, e2 = tri[0:3].T, tri[3:6].T, tri[6:9].T
    c = v0 + (e1 + e2) / 3.0
    n = torch.linalg.cross(e1, e2)
    n = n / n.norm(dim=1, keepdim=True)
    return c + 0.01 * n, -n, torch.full_like(c[:, 0], 0.011)


def check_opaque(tag, tc, scene, rays, card, flat_scene=None) -> tuple:
    """B2 over the opaque shadow pool against its twin on the shadow
    wavefront `rays` (occlusion masks equal), against the flat pool's
    kernel when given (equal), beside B2 over the full pool; on leaf_rays
    the full pool hits every alpha triangle and the opaque pool none, in
    kernel and twin. Times kernel and twin. Returns (name, ms, plain_ms,
    bound_ms, bound_by, max_abs_err) and the kernel's occlusion mask."""
    from hydracore_tpu_torch.ops.traverse_cluster import LEVEL_TABLES

    pool = tc.scene_pool(scene, opaque_only=True)
    twin = {k: v for k, v in pool.items()
            if k not in LEVEL_TABLES and k != "opaque_pool"}
    full = tc.scene_pool(scene)

    def kernel(r, p=pool):
        return tc.cluster_traverse(r, any_hit_mode=True, **p)

    tk, sk = kernel(rays)
    _, st = tc.cluster_traverse_plain(rays, any_hit_mode=True, **twin)
    _, sf = tc.cluster_traverse(rays, any_hit_mode=True, **full)
    torch.cuda.synchronize()
    hk, ht = sk >= 0, st >= 0
    err = float((hk.float() - ht.float()).abs().max())
    n_act = int((rays[:, :, 7] > 0).sum())
    log(f"{tag} shadow: {n_act} active rays, occluded by the opaque pool "
        f"{int(hk.sum())}, by the full pool {int((sf >= 0).sum())}; masks "
        f"{'equal' if torch.equal(hk, ht) else 'DIFFERENT'} to the twin's")
    if not torch.equal(hk, ht):
        raise AssertionError(f"{tag}: opaque-pool B2 differs from its twin on "
                             f"{int((hk != ht).sum())} rays")
    if not ((sf >= 0) & ~hk).any():
        raise AssertionError(f"{tag}: no ray is occluded by alpha geometry alone")
    if flat_scene is not None:
        _, s_flat = kernel(rays, tc.scene_pool(flat_scene, opaque_only=True))
        if not torch.equal(hk, s_flat >= 0):
            raise AssertionError(f"{tag}: chunked and flat opaque pools differ")
    o, d, t = leaf_rays(scene)
    blocks, R = tc._to_blocks(o, d, t, None, tc.R_BLK)
    hit_full = tc.cluster_traverse(blocks, any_hit_mode=True, **full)[1]
    hit_opq = kernel(blocks)[1]
    hit_twin = tc.cluster_traverse_plain(blocks, any_hit_mode=True, **twin)[1]
    hit_full, hit_opq, hit_twin = (x.reshape(-1)[:R] >= 0
                                   for x in (hit_full, hit_opq, hit_twin))
    log(f"{tag} zeroed lanes: {R} rays onto alpha triangles: full pool hits "
        f"{int(hit_full.sum())}, opaque pool kernel {int(hit_opq.sum())}, twin "
        f"{int(hit_twin.sum())}")
    if not hit_full.all() or hit_opq.any() or hit_twin.any():
        raise AssertionError(f"{tag}: a zeroed lane hit, or an alpha triangle "
                             "was missed in the full pool")
    err = max(err, float((hit_opq.float() - hit_twin.float()).abs().max()))
    ms = lab.time_ms(lambda: kernel(rays), 20, rays.device)
    plain = lab.time_ms(lambda: tc.cluster_traverse_plain(
        rays, any_hit_mode=True, **twin), 1, rays.device)
    bms, by = cluster_bound_ms(scene, rays, tk.reshape(-1), live_lanes(scene))
    log(f"{tag} shadow: kernel {ms:.4f} ms, twin {plain:.4f} ms, bound "
        f"{bms:.5f} ms ({by}, {int(live_lanes(scene).sum())} live lanes) "
        f"[{card}]")
    return ("shadow", ms, plain, bms, by, err), hk.reshape(-1)


def textured_phase(card, pt, tc, tp, trace_api, dev) -> list:
    """Phase 14: the textured scene of textured_desc assembled through
    assemble(SceneDesc) into the git-ignored hydracore_tpu_torch/_build/
    (its texture files written there and removed after): B1 on its primary
    and bounce wavefronts against the twin, B2 over the opaque shadow pool
    against its twin, flat and in chunks of 128 clusters (check_opaque),
    the dense alpha layer timed on the shadow wavefront, the main path at
    1024^2 (the opaque-pool counter > 0, B2 over the full pool 0) on both
    pools with a profile of one pass, and 64x64 card images against the CPU
    twins on the cluster route (split shadows) and on the packet route (the
    layered walk through B4 closest hit, B4 any hit 0). Returns the two
    "kernels" rows of B2 over the opaque pool."""
    from hydracore_tpu_torch.scene.lights import LIGHT_AREA_RECT
    from hydracore_tpu_torch.scene.scene import assemble
    from hydracore_tpu_torch.utils.build import BUILD_DIR

    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = tempfile.mkdtemp(prefix="textured_", dir=BUILD_DIR)
    try:
        t0 = time.time()
        desc = textured_desc(lib, WIDTH, HEIGHT)
        host = assemble(desc)
        st = host.settings
        gates = ("has_diff_tex", "has_refl_tex", "has_bump", "has_blend",
                 "has_alpha", "has_ies", "has_env_back", "has_sky")
        if not all(getattr(st, g) for g in gates) or st.blend_depth != 2:
            raise AssertionError(f"phase 14: gates {[getattr(st, g) for g in gates]}"
                                 f", blend depth {st.blend_depth}")
        if trace_api._pick(host) is not tc or not trace_api.has_shadow_split(host):
            raise AssertionError("phase 14: the scene does not take the cluster "
                                 "route with split shadows")
        n_alpha = int((host.alpha_tri_id >= 0).sum())
        log(f"phase 14 textured scene: {host.num_triangles} triangles, "
            f"{real_boxes(host).shape[1]} clusters (Cp {host.cl_tris.shape[0]}), "
            f"texture heap {host.texels.numel() * 4 / 2**20:.1f} MiB in "
            f"{host.tex_table.shape[0]} slots, alpha set {n_alpha} triangles "
            f"(A {host.alpha_tri9f.shape[1]}), assembled in "
            f"{time.time() - t0:.2f} s")
        host_part = assemble(desc, part_cap=128)
        P = host_part.cl_tris.shape[0] if host_part.cl_tris.dim() == 4 else 1
        if P < 2:
            raise AssertionError(f"phase 14: the pool has {P} chunks at part_cap 128")
        scene, part = host.to(dev), host_part.to(dev)
        rect = int(torch.nonzero(host.lights.ltype == LIGHT_AREA_RECT)[0])
        raw = wavefronts(pt, scene, light_row=rect)
        cases = cluster_cases(tc, raw)
        b1 = check_kernels("phase 14 textured", tc, scene, cases[:2], card)
        shadow = cases[2][1]
        rec_flat, occ = check_opaque("phase 14 textured flat", tc, scene,
                                     shadow, card)
        rec_part, _ = check_opaque(f"phase 14 textured {P} chunks", tc, part,
                                   shadow, card, flat_scene=scene)
        # the first alpha layer of those shadow rays, timed alone
        _, o, d, t_max, act, _ = raw[2]
        n = o.shape[0]
        searching = act & ~occ[:n]
        t_lo = torch.full_like(t_max, 1e-5)
        lay_ms, (_, tid, _, _) = lab.time_ms(
            lambda: trace_api.alpha_layer_hit(scene, o, d, t_lo, t_max,
                                              searching), 5, dev, result=True)
        log(f"phase 14 textured: B1 primary {b1['closest'][0][1]:.4f} ms, "
            f"bounce {b1['closest'][1][1]:.4f} ms; B2 over the opaque pool "
            f"{rec_flat[1]:.4f} ms (flat), {rec_part[1]:.4f} ms ({P} chunks); "
            f"alpha_layer_hit {lay_ms:.4f} ms on {int(searching.sum())} rays "
            f"(hits {int((tid >= 0).sum())}) [{card}]")
        log(f"phase 14 assembly and kernel checks: {time.time() - t0:.2f} s")
        t0 = time.time()
        counts = drive_main_path("phase 14 textured", pt, tc, tp, scene, card,
                                 {"closest_launches", "opaque_any_launches"})
        profile_pass(pt, scene, card, "phase 14 textured")
        part_counts = drive_main_path(
            f"phase 14 textured {P} chunks", pt, tc, tp, part, card,
            {"closest_launches", "opaque_any_launches"})
        del scene, part
        log(f"phase 14 main paths: {time.time() - t0:.2f} s")
        card_vs_cpu("phase 14 cluster", pt, assemble(desc, 64, 64))
        small_pkt = assemble(desc, 64, 64, traversal="packet")
        tc.reset_launch_counts()
        tp.reset_launch_counts()
        card_vs_cpu("phase 14 packet", pt, small_pkt)
        pkt = launch_counts(tc, tp)
        log(f"phase 14 packet 64x64: launches {pkt}")
        if (pkt["pkt_closest_launches"] == 0 or pkt["pkt_any_launches"] != 0
                or any(pkt[k] for k in COUNTERS[:5])):
            raise AssertionError("phase 14 packet: the layered walk did not run "
                                 f"through B4 closest hit alone: {pkt}")
    finally:
        shutil.rmtree(lib, ignore_errors=True)
    at = "hydracore_tpu/ops/traverse_cluster.py"
    rows = []
    for label, rec, n, line in (
            (f"flat pool Cp {host.cl_tris.shape[0]}", rec_flat,
             counts["opaque_any_launches"], 576),
            (f"{P} chunks of 128", rec_part, part_counts["opaque_any_launches"],
             663)):
        rows.append({
            "name": f"B2 cluster traversal over the opaque shadow pool, any hit,"
                    f" textured scene, {label} (shadow)",
            "route": "cuda", "source": CLUSTER_CU, "replaces": f"{at}:{line}",
            "launches": n, "max_abs_err": rec[5], "ms": rec[1],
            "plain_ms": rec[2], "bound_ms": rec[3], "bound_by": rec[4],
            "library_ms": None})
    return rows


CLUSTER_CU = "hydracore_tpu_torch/csrc/traverse_cluster.cu"
PACKET_CU = "hydracore_tpu_torch/csrc/traverse_packet.cu"
LAB_SRCS = ["lab_gather.cu", "lab_prims.cu", "lab_subvisit.cu",
            "lab_cluster_cost.cu", "lab_cluster.cu", "lab_packet.cu"]


def lab_row(name, src, replaces, launches, err, ms, plain_ms, bound,
            library_ms=None) -> dict:
    """One "kernels" record of the kernel lab; bound is (ms, bound by)."""
    return {"name": name, "route": "cuda",
            "source": f"hydracore_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms}


def lab_gather(card, dev="cuda") -> list:
    """T7 at the tool's size: both kernels equal to their plain versions,
    timed beside them and beside embedding_bag over the same (R, 16) index
    matrix (built outside the timed call); then the tool's main()."""
    from hydracore_tpu_torch.tools import bench_pallas_gather as t7

    pool, idx = t7.inputs(device=dev)
    S = pool.shape[0]
    idx16 = (idx.long() + torch.arange(t7.ITERS, device=idx.device)) % S
    recs = {}
    for name, onehot in t7.VARIANTS.items():
        out_k = t7.gather(pool, idx, onehot=onehot)
        out_p = t7.gather_plain(pool, idx, onehot=onehot)
        torch.cuda.synchronize()
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"phase 12 T7 {name}: kernel differs from plain")
        rows = pool.to(torch.bfloat16).to(torch.float32) if onehot else pool
        lib = torch.nn.functional.embedding_bag(idx16, rows, mode="sum")
        lib_err = float((lib - out_k).abs().max())
        plain = lab.time_ms(lambda: t7.gather_plain(pool, idx, onehot=onehot),
                            3, dev)
        lib_ms = lab.time_ms(lambda: torch.nn.functional.embedding_bag(
            idx16, rows, mode="sum"), 5, dev)
        log(f"phase 12 T7 {name}: equal to the plain version; plain "
            f"{plain:.4f} ms, embedding_bag {lib_ms:.4f} ms (max abs diff "
            f"{lib_err:.3e}: another summation order) [{card}]")
        recs[name] = (plain, lib_ms)
    t7.reset_launch_counts()
    res = t7.main(device=dev)
    counts = {"taa": t7.gather_launches, "onehot": t7.onehot_launches}
    at = "tools/bench_pallas_gather.py"
    return [lab_row(f"T7 row gather, {name}", "lab_gather.cu",
                    f"{at}:{32 if name == 'taa' else 43}", counts[name], 0.0,
                    res[name]["ms"], recs[name][0],
                    (res[name]["bound_ms"], res[name]["bound_by"]),
                    recs[name][1])
            for name in t7.VARIANTS]


def prim_library(x, xi) -> dict:
    """For the probes that one PyTorch call computes, that call (an index
    that the call takes is made before, outside the timed call): k -> fn().
    k2's row index is a reduction, k8 two of them, k7 reads nothing."""
    i4 = (xi[0, 2:3] % 60).long()
    return {
        1: lambda: x[3:4, 5:6].expand(1, 128).clone(),
        3: lambda: x[3:4, :8].sum(1, keepdim=True).expand(1, 128),
        4: lambda: x.index_select(0, i4),
        5: lambda: x[2:3, ::16].sum(1, keepdim=True).expand(1, 128),
        6: lambda: x[56:57].clone(),
        9: lambda: x[0:1].view(torch.int32).float(),
        10: lambda: torch.nn.functional.pad(x[0:1, ::16], (0, 120)),
    }


def lab_prims(card, dev="cuda") -> list:
    """T6: each probe equal to its plain version and, where there is one,
    to the one-call PyTorch form (prim_library) on the tool's x and xi;
    plain and library timed beside it (the library over a CUDA graph of 200
    calls, as main() times the kernel); then the tool's main() (1,000
    launches a probe)."""
    from hydracore_tpu_torch.tools import proto_prims as t6

    x, xi = t6.inputs(dev)
    library = prim_library(x, xi)
    plain, lib_ms = {}, {}
    for k in t6.NAMES:
        out_k = t6.prim(k, x, xi)
        if not torch.equal(out_k, t6.prim_plain(k, x, xi)):
            raise AssertionError(f"phase 12 T6 k{k}: kernel differs from plain")
        if k in library and not torch.equal(out_k, library[k]()):
            raise AssertionError(f"phase 12 T6 k{k}: the library call differs")
        plain[k] = lab.time_ms(lambda: t6.prim_plain(k, x, xi), 20, dev)
        lib_ms[k] = (lab.time_ms(library[k], 200, dev, graph=True)
                     if k in library else None)
    log("phase 12 T6: the ten probes equal their plain versions and the "
        f"library calls of k{', k'.join(map(str, library))}; library "
        + ", ".join(f"k{k} {lib_ms[k] * 1e3:.3f}" for k in library)
        + f" us a call [{card}]")
    t6.reset_launch_counts()
    res = t6.main(device=dev)
    if not all(r["ok"] for r in res.values()):
        raise AssertionError("phase 12 T6: a probe failed in main()")
    n = t6.prim_launches
    lines = {1: 35, 2: 45, 3: 54, 4: 64, 5: 73, 6: 83, 7: 93, 8: 116,
             9: 126, 10: 135}
    return [lab_row(f"T6 probe k{k} ({t6.NAMES[k]}; launches of all ten)",
                    "lab_prims.cu", f"tools/proto_prims.py:{lines[k]}", n, 0.0,
                    res[f"k{k}"]["ms"], plain[k],
                    (res[f"k{k}"]["bound_ms"], res[f"k{k}"]["bound_by"]),
                    lib_ms[k])
            for k in t6.NAMES]


def lab_subvisit(card, dev="cuda") -> list:
    """T5 at the tool's size: every variant's kernel against its plain
    version (output words equal on >= 99.9% of rays, t with the lane bits
    cleared within rtol 1e-5), timed beside it; then the tool's main()."""
    from hydracore_tpu_torch.tools import proto_subvisit as t5

    rays, tris, lst = t5.inputs(device=dev)
    recs = {}
    for name, (n_bands, inter) in t5.VARIANTS.items():
        out_k = t5.subvisit(rays, tris, lst, n_bands, inter)
        out_p = t5.subvisit_plain(rays, tris, lst, n_bands, inter)
        torch.cuda.synchronize()
        wk, wp = out_k.view(torch.int32), out_p.view(torch.int32)
        same = float((wk == wp).float().mean())
        clear = lambda w: (w & -128).view(torch.float32)  # noqa: E731
        err = float((clear(wk) - clear(wp)).abs().max())
        rel = float(((clear(wk) - clear(wp)).abs() / clear(wp).abs()).max())
        hits = int((out_k < 1e38).sum())
        plain = lab.time_ms(lambda: t5.subvisit_plain(rays, tris, lst, n_bands,
                                                      inter), 1, dev)
        log(f"phase 12 T5 {name}: {hits} of {out_k.numel()} rays hit, words "
            f"equal on {same:.6f}, t rel err {rel:.3e}; plain {plain:.4f} ms "
            f"[{card}]")
        if same < 0.999 or rel > 1e-5:
            raise AssertionError(f"phase 12 T5 {name}: kernel vs plain")
        recs[name] = (err, plain)
    t5.reset_launch_counts()
    res = t5.main(device=dev)
    return [lab_row(f"T5 sub-visit, {name} (launches of the "
                    f"{'plain' if name == 'plain' else 'sub'} kernel)",
                    "lab_subvisit.cu",
                    f"tools/proto_subvisit.py:{52 if name == 'plain' else 68}",
                    t5.plain_launches if name == "plain" else t5.sub_launches,
                    recs[name][0], res[name]["ms"], recs[name][1],
                    (res[name]["bound_ms"], res[name]["bound_by"]))
            for name in t5.VARIANTS]


def lab_cluster_cost(card, tc, dev="cuda") -> list:
    """T1 on bench_scene at 512x512: every lab variant equal to its plain
    version (floor a copy, the words and counts equal), B1 ("full") against
    its twin, each timed beside its plain version; then the tool's main(),
    which prints the split of B1's time."""
    from hydracore_tpu_torch.scene.procedural import bench_scene
    from hydracore_tpu_torch.tools import exp_kernel_cost as t1

    scene = bench_scene(t1.W, t1.W).to(dev)
    rays, oct_ = t1.lab_rays(scene)
    cbl = scene.cl_bounds_oct
    recs = {}
    for v in t1.ALL:
        kind, n = t1.parse(v)
        if kind == "full":
            pool = (cbl, scene.cl_tris, scene.cl_oct_perm)
            tk, sk = tc.cluster_traverse(rays, **tc.scene_pool(scene))
            tt, st = tc.cluster_traverse_plain(rays, *pool)
            torch.cuda.synchronize()
            hit = sk >= 0
            same = float((sk[hit] == st[hit]).float().mean())
            if (not torch.equal(hit, st >= 0) or not hit.any()
                    or not torch.equal(tk[hit], tt[hit]) or same < 0.999):
                raise AssertionError("phase 12 T1 full: B1 differs from its "
                                     f"twin (slots equal on {same})")
            err = float((tk[hit] - tt[hit]).abs().max())
            plain = lab.time_ms(lambda: tc.cluster_traverse_plain(rays, *pool),
                                1, dev)
            recs[v] = (err, plain, cluster_bound_ms(scene, rays, tk.reshape(-1)))
        else:
            out_k, outi_k = t1.cluster_cost(kind, rays, oct_, cbl, n)
            out_p, outi_p = t1.cluster_cost_plain(kind, rays, oct_, cbl, n)
            torch.cuda.synchronize()
            if not (torch.equal(out_k, out_p) and torch.equal(outi_k, outi_p)):
                raise AssertionError(f"phase 12 T1 {v}: kernel differs from plain")
            plain = lab.time_ms(
                lambda: t1.cluster_cost_plain(kind, rays, oct_, cbl, n), 1, dev)
            recs[v] = (0.0, plain, t1.variant_bound_ms(kind, n, rays, cbl))
        what = (f"B1 against its twin: hit masks and t equal, slots equal "
                f"on {same:.6f}" if kind == "full"
                else "equal to the plain version")
        log(f"phase 12 T1 {v}: {what}; plain {recs[v][1]:.4f} ms, bound "
            f"{recs[v][2][0]:.5f} ms ({recs[v][2][1]}) [{card}]")
    t1.reset_launch_counts()
    tc.reset_launch_counts()
    res = t1.main("all", device=dev)
    counts = {"floor": t1.floor_launches, "fm": t1.floor_launches,
              "stagea": t1.stagea_launches, "compact": t1.compact_launches,
              "full": tc.closest_launches}
    lines = {"floor": 104, "fm": 228, "stagea": 111, "compact": 168,
             "full": 219}
    whose = {"floor": "the floor kernel: floor, fmN", "fm": "the floor kernel: "
             "floor, fmN", "stagea": "the stage A kernel", "compact":
             "the compaction kernel", "full": "B1 on the lab's rays"}
    rows = []
    for v in t1.ALL:
        kind, _ = t1.parse(v)
        src = CLUSTER_CU.split("/")[-1] if kind == "full" else "lab_cluster_cost.cu"
        rows.append(lab_row(
            f"T1 cluster cost, {v} (launches of {whose[kind]})", src,
            f"tools/exp_kernel_cost.py:{lines[kind]}", counts[kind],
            recs[v][0], res[v]["ms"], recs[v][1], recs[v][2]))
    return rows


def lab_proto_cluster(card, dev="cuda") -> list:
    """T2 at the tool's size (262,144 probe rays, C 256): the tool's main()
    with its counter read, then each of its eight jobs' outputs against the
    plain version (out and outi equal bit for bit), the plain version timed
    on the same inputs; the MXU job without a hit in either; the MXU variant
    once more with random plane columns in pk, where it must hit and agree
    too."""
    from hydracore_tpu_torch.tools import proto_cluster as t2

    t2.reset_launch_counts()
    res = t2.main(device=dev)
    launches = t2.launches
    rays = {rb: torch.tensor(t2.probe_rays(rb)).to(dev) for rb in t2.R_BLKS}
    synth = {a: t2.synth(t2.C, a) for a in sorted({j[1] for j in t2.JOBS})}
    scenes = {a: tuple(torch.tensor(x).to(dev) for x in s)
              for a, s in synth.items()}
    planes = torch.tensor(t2.with_planes(synth[16][2])).to(dev)
    recs = {}
    for v, a, mxu, rb, pk in [j + (None,) for j in t2.JOBS] + [
            ("full", 16, True, 1024, planes)]:
        cb, tris, pk0 = scenes[a]
        pk = pk0 if pk is None else pk
        mode = t2.MODES[v]
        name = t2.job_name(v, a, mxu, rb)
        out_k, outi_k = (t2.proto_cluster(rays[rb], cb, tris, pk, mxu, mode)
                         if pk is planes else res[name]["out"])
        plain, (out_p, outi_p) = lab.time_ms(lambda: t2.proto_cluster_plain(
            rays[rb], cb, tris, pk, mxu, mode), 1, dev, result=True)
        if not (torch.equal(out_k, out_p) and torch.equal(outi_k, outi_p)):
            raise AssertionError(f"phase 13 T2 {name}: kernel differs from plain")
        hits = [int((o[:, :, 0] >= 0).sum()) for o in (outi_k, outi_p)]
        n_act = out_k[:, 0, 1]
        what = "plane columns" if pk is planes else "the tool's synth"
        log(f"phase 13 T2 {name} ({what}): kernel equal to the plain version "
            f"(out, outi); n_act per block {float(n_act.min()):.0f}-"
            f"{float(n_act.max()):.0f}, hits {hits[0]}; plain {plain:.4f} ms "
            f"[{card}]")
        if pk is planes:
            if hits[0] == 0:
                raise AssertionError("phase 13 T2: no Plucker hit with plane columns")
        elif mxu and hits != [0, 0]:
            raise AssertionError(f"phase 13 T2 {name}: the MXU job hit: {hits}")
        else:
            recs[name] = plain
    return [lab_row(f"T2 proto cluster, {name} (launches of all eight jobs)",
                    "lab_cluster.cu", "tools/proto_cluster.py:189",
                    launches, 0.0, res[name]["ms"], recs[name],
                    (res[name]["bound_ms"], res[name]["bound_by"]))
            for name in recs]


# the rays of each set on which T3 and T4 are held against their plain
# version: 16 T4 packets, 128 T3 packets from the middle of the set (the
# middle columns of the coherent grid, which hit the scene); the plain walk
# steps once per entry its busiest packet pops, a few ms a step at 2^18 rays
N_PLAIN = 16384
PLAIN_AT = (262144 - N_PLAIN) // 2


def lab_packet_walks(card, tp, dev="cuda") -> list:
    """T3 and T4 on bench_scene(512, 512) with the tools' two ray sets of
    262,144 rays: each tool's main() with its counter read, then its
    kernel's outputs against the plain version on N_PLAIN rays from the
    middle of the set (t, u, v, slot and visits equal), the packets at
    MAX_VISITS logged; then B4 (32-ray packets) on the same rays, held
    against both on the packets under their MAX_VISITS (hit masks equal, t
    equal on hits, slots equal on >= 99.9%), the three timed side by side
    against one bound (packet_bound_ms)."""
    from hydracore_tpu_torch.scene.procedural import bench_scene
    from hydracore_tpu_torch.tools import proto_packet as t3
    from hydracore_tpu_torch.tools import proto_packet2 as t4

    scene = bench_scene(t3.W, t3.W).to(dev)
    rays = t3.tool_rays()
    log(f"phase 13 packet walks: bench_scene(512, 512), "
        f"{scene.wbvh_nodes.shape[0]} wide nodes (depth {scene.wbvh_depth}), "
        f"{scene.wbvh_tri9f.shape[0]} leaf blocks; {t3.N_RAYS} rays a set")
    res, launches, recs = {}, {}, {}
    for tool in (t3, t4):
        tool.reset_launch_counts()
        res[tool.TOOL] = tool.main(device=dev, scene=scene)
        launches[tool.TOOL] = tool.launches
        nodes, tris = tool.pack_scene(scene)
        for name, (ro, rd) in rays.items():
            packed = tool.pack_rays(ro, rd).to(dev)
            k = res[tool.TOOL][name]["out"]
            plain, p = lab.time_ms(lambda: tool.unpack(
                tool.packet_traverse_plain(tool.ray_range(
                    packed, PLAIN_AT, N_PLAIN), nodes, tris)), 1, dev,
                result=True)
            at, n_pk = PLAIN_AT // tool.P, N_PLAIN // tool.P
            same = [torch.equal(x[PLAIN_AT:PLAIN_AT + N_PLAIN], y)
                    for x, y in zip(k[:4], p[:4])]
            same.append(torch.equal(k[4][at:at + n_pk], p[4]))
            if not all(same):
                raise AssertionError(f"phase 13 T{tool.TOOL} {name}: kernel "
                                     f"differs from plain (t, slot, u, v, "
                                     f"visits equal: {same})")
            vis = k[4]
            at_max = int((vis >= tool.MAX_VISITS).sum())
            log(f"phase 13 T{tool.TOOL} {name}: kernel equal to the plain "
                f"version on rays {PLAIN_AT}-{PLAIN_AT + N_PLAIN - 1} "
                f"(packets {at}-{at + n_pk - 1} of "
                f"{tool.P}: t, u, v, slot, visits); hits {int((k[1] >= 0).sum())}"
                f", entries popped per packet mean {float(vis.float().mean()):.1f}"
                f", most {int(vis.max())}; {at_max} of {vis.numel()} packets at "
                f"MAX_VISITS {tool.MAX_VISITS}; plain {plain:.4f} ms on "
                f"those rays [{card}]")
            recs[tool.TOOL, name] = plain
    bounds = {}
    for name, (ro, rd) in rays.items():
        packets, _ = tp._to_packets(torch.tensor(ro).to(dev),
                                    torch.tensor(rd).to(dev), 1e30, None)
        tk, _, _, sk, nk = tp.packet_traverse(packets, scene.pkt_nodes,
                                              scene.pkt_tris)
        torch.cuda.synchronize()
        if int(nk.max()) >= tp.MAX_VISITS:
            raise AssertionError(f"phase 13 B4 {name}: a packet reached MAX_VISITS")
        log(f"phase 13 B4 {name}: hits {int((sk >= 0).sum())}, entries popped "
            f"per packet of {tp.PKT} mean {float(nk.float().mean()):.1f}, most "
            f"{int(nk.max())}")
        tk, sk = tk.reshape(-1), sk.reshape(-1)
        for tool in (t3, t4):
            t, slot, _, _, vis = res[tool.TOOL][name]["out"]
            under = (vis < tool.MAX_VISITS).repeat_interleave(tool.P)
            hb, ht = (sk >= 0)[under], (slot >= 0)[under]
            if not torch.equal(hb, ht):
                raise AssertionError(f"phase 13 {name}: B4 and T{tool.TOOL} "
                                     f"hit masks differ on {int((hb != ht).sum())}")
            h = under & (sk >= 0)
            t_same = torch.equal(tk[h], t[h])
            s_same = float((sk[h] == slot[h]).float().mean())
            log(f"phase 13 {name}: B4 against T{tool.TOOL} on the rays of "
                f"{int(under.sum()) // tool.P} packets under MAX_VISITS: hit "
                f"masks equal, t equal on hits: {t_same}, slots equal on "
                f"{s_same:.6f}")
            if not t_same or s_same < 0.999:
                raise AssertionError(f"phase 13 {name}: B4 against T{tool.TOOL}")
        b4_ms = lab.time_ms(lambda: tp.packet_traverse(
            packets, scene.pkt_nodes, scene.pkt_tris), 10, dev, graph=True)
        bms, by, note = packet_bound_ms(scene, packets, tk)
        bounds[name] = (bms, by)
        log(f"phase 13 {name}: packets of 32 (B4) {b4_ms:.4f} ms, of 128 (T3) "
            f"{res[3][name]['ms']:.4f} ms, of 1024 (T4) {res[4][name]['ms']:.4f}"
            f" ms; bound {bms:.5f} ms ({by}: {note}) [{card}]")
    rows = []
    for tool in (t3, t4):
        line = 163 if tool is t3 else 152
        for name in rays:
            rows.append(lab_row(
                f"T{tool.TOOL} packet walk of {tool.P}, {name} rays on "
                f"bench_scene 512 (launches of both sets; plain ms on rays "
                f"{PLAIN_AT}-{PLAIN_AT + N_PLAIN - 1})", "lab_packet.cu",
                f"tools/{tool.__name__.split('.')[-1]}.py:{line}",
                launches[tool.TOOL], 0.0, res[tool.TOOL][name]["ms"],
                recs[tool.TOOL, name], bounds[name]))
    return rows


def kernel_rows(kernels, label, source, replaces, recs, launches) -> list:
    """The "kernels" records of one main path: one row per hit mode, times
    summed over the wavefronts named in the row. `kernels` names the
    closest-hit and the any-hit kernel, `launches` holds their counts from
    the main path's run."""
    rows = []
    for mode, kernel, what, count in zip(("closest", "any"), kernels,
                                         ("closest hit", "any hit"), launches):
        r = recs[mode]
        rows.append({
            "name": f"{kernel}, {what}, {label} "
                    f"({' + '.join(x[0] for x in r)})",
            "route": "cuda",
            "source": source,
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
    from hydracore_tpu_torch.integrators import pt
    from hydracore_tpu_torch.ops import trace_api
    from hydracore_tpu_torch.ops import traverse_cluster as tc
    from hydracore_tpu_torch.ops import traverse_dense as td
    from hydracore_tpu_torch.ops import traverse_packet as tp
    from hydracore_tpu_torch.scene.procedural import bench_builder, bench_scene
    from hydracore_tpu_torch.scene.scene import assemble
    from hydracore_tpu_torch.tools import bench_pallas_gather as t7
    from hydracore_tpu_torch.tools import exp_kernel_cost as t1
    from hydracore_tpu_torch.tools import proto_cluster as t2
    from hydracore_tpu_torch.tools import proto_packet as t3
    from hydracore_tpu_torch.tools import proto_packet2 as t4
    from hydracore_tpu_torch.tools import proto_prims as t6
    from hydracore_tpu_torch.tools import proto_subvisit as t5
    from hydracore_tpu_torch.utils import build

    dev = torch.device("cuda")
    card = lab.device_label(dev)
    t_start = time.time()

    # ---- phase 1: build every native source, compilers in parallel
    t0 = time.time()
    srcs = ["traverse_cluster.cu", "traverse_packet.cu", "bvh_builder.cpp",
            *LAB_SRCS]
    started = {s: build.start_build(s) for s in srcs}
    for s in srcs:
        build.finish_build(s, started[s])
    tc._kernel_lib()
    tp._kernel_lib()
    for tool in (t1, t2, t3, t4, t5, t6, t7):
        tool._kernel_lib()
    log(f"phase 1 build: {time.time() - t0:.2f} s ({', '.join(srcs)})")

    # ---- phase 2-5: the flat pool (B1, B2)
    t0 = time.time()
    host_scene = bench_scene(WIDTH, HEIGHT, DEPTH)
    scene = host_scene.to(dev)
    log(f"phase 2 flat scene: {host_scene.num_triangles} triangles, "
        f"{real_boxes(host_scene).shape[1]} clusters (Cp "
        f"{host_scene.cl_tris.shape[0]}), built in {time.time() - t0:.2f} s")
    flat_cases = cluster_cases(tc, wavefronts(pt, scene))
    flat_recs = check_kernels("phase 3 flat", tc, scene, flat_cases, card)
    group_sizes("phase 3 flat", tc, scene, flat_cases, card)
    log(f"phase 4 flat: {N_PASS} passes (4 before the instanced and "
        "partitioned paths joined the run)")
    flat_counts = drive_main_path("phase 4 flat", pt, tc, tp, scene, card,
                                  {"closest_launches", "any_launches"})
    img_flat_cluster = card_vs_cpu("phase 4 flat", pt,
                                   bench_scene(64, 64, DEPTH),
                                   max_depth=CHECK_DEPTH)
    profile_pass(pt, scene, card, "phase 5 flat")
    del scene
    log(f"phases 2-5 flat: {time.time() - t0:.2f} s")

    # ---- phase 6: the instanced layout (B3), assembled from a SceneDesc
    t0 = t_phase = time.time()
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
                              cluster_cases(tc, wavefronts(pt, inst_scene)),
                              card)
    inst_counts = drive_main_path(
        "phase 6 instanced", pt, tc, tp, inst_scene, card,
        {"inst_closest_launches", "inst_any_launches"})
    profile_pass(pt, inst_scene, card, "phase 6 instanced")
    del inst_scene
    img_inst = card_vs_cpu("phase 6 instanced", pt,
                           assemble(desc, 64, 64, instancing="auto"),
                           max_depth=CHECK_DEPTH)
    t0 = time.time()
    flattened = assemble(desc, 64, 64, instancing="off")
    img_flat = pt.render(flattened, spp=8, seed=SEED, max_depth=CHECK_DEPTH,
                         device="cuda").cpu()
    mse = float(((img_inst - img_flat) ** 2).mean())
    log(f"phase 6 instanced 64x64 8 spp depth {CHECK_DEPTH}: MSE {mse:.3e} "
        f"against the flattened assembly ({flattened.num_triangles} triangles, pool "
        f"{tuple(flattened.cl_tris.shape[:-2])}, assembled and rendered in "
        f"{time.time() - t0:.2f} s)")
    if not mse < 1e-4:
        raise AssertionError(f"instanced vs flattened image: MSE {mse}")
    del flattened
    log(f"phase 6 instanced: {time.time() - t_phase:.2f} s")

    # ---- phase 7: the partitioned pool (B1, B2 over the groups of 3 chunks)
    t0 = t_phase = time.time()
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
    part_raw = wavefronts(pt, part_scene)
    part_cases = cluster_cases(tc, part_raw)
    part_recs = check_kernels("phase 7 partitioned", tc, part_scene,
                              part_cases, card, flat_scene=repacked)
    group_sizes("phase 7 partitioned", tc, part_scene, part_cases, card)
    del repacked
    part_counts = drive_main_path("phase 7 partitioned", pt, tc, tp,
                                  part_scene, card,
                                  {"closest_launches", "any_launches"})
    profile_pass(pt, part_scene, card, "phase 7 partitioned")
    log(f"phase 7 partitioned: {time.time() - t_phase:.2f} s")

    # ---- phase 8: the packet route (B4) on the partitioned phase's geometry
    t0 = t_phase = time.time()
    host_pkt = bench_scene(WIDTH, HEIGHT, DEPTH, builder=big, traversal="packet")
    if trace_api._pick(host_pkt) is not tp or host_pkt.cl_tris.dim() != 3:
        raise AssertionError("traversal='packet' was not honoured")
    log(f"phase 8 packet scene: {host_pkt.num_triangles} triangles, "
        f"{host_pkt.wbvh_nodes.shape[0]} wide nodes (depth "
        f"{host_pkt.wbvh_depth}), {host_pkt.wbvh_tri9f.shape[0]} leaf blocks, "
        f"pools {(host_pkt.pkt_nodes.numel() + host_pkt.pkt_tris.numel()) * 4 / 2**20:.1f}"
        f" MiB, built in {time.time() - t0:.2f} s")
    pkt_scene = host_pkt.to(dev)
    # the wavefronts as this route's path tracer sends them: not sorted
    pkt_raw = wavefronts(pt, pkt_scene, sort=False)
    pkt_recs = check_packet("phase 8 packet", tp, pkt_scene, pkt_raw, card)
    packet_profile("phase 8 packet", tp, pkt_scene, pkt_raw, card)
    kernel_code("phase 8 packet", "traverse_packet.cu")
    del pkt_raw
    # and B4 on the very rays the chunked B1/B2 got in phase 7 (sorted)
    srt_recs = check_packet("phase 8 packet, sorted rays", tp, pkt_scene,
                            part_raw, card, twin=False)
    for (name, o, d, t_max, act, any_hit), (_, blocks, _) in zip(
            part_raw, cluster_cases(tc, part_raw)):
        _, s_cl = tc.cluster_traverse(blocks, any_hit_mode=any_hit,
                                      **tc.scene_pool(part_scene))
        s_cl = s_cl.reshape(-1)[:o.shape[0]]
        t_b4, s_b4 = srt_recs["hits"][name]
        same_mask = float(((s_cl >= 0) == (s_b4 >= 0)).float().mean())
        both = (s_cl >= 0) & (s_b4 >= 0)
        tri_cl = part_scene.cl_slot_tri[s_cl[both].long()]
        tri_b4 = pkt_scene.wbvh_slot_tri[s_b4[both].long()]
        same_tri = float((tri_cl == tri_b4).float().mean())
        log(f"phase 8 packet, sorted rays {name}: B4 against the chunked "
            f"{'B2' if any_hit else 'B1'}: hit masks equal on {same_mask:.6f}"
            + ("" if any_hit else f", triangle equal on {same_tri:.6f}"))
        if same_mask < 0.9999 or (not any_hit and same_tri < 0.999):
            raise AssertionError(f"phase 8 {name}: B4 against the chunked kernel")
    del part_scene
    pkt_counts = drive_main_path(
        "phase 8 packet", pt, tc, tp, pkt_scene, card,
        {"pkt_closest_launches", "pkt_any_launches"})
    profile_pass(pt, pkt_scene, card, "phase 8 packet")
    del pkt_scene
    log(f"phase 8 packet: {time.time() - t_phase:.2f} s")

    # ---- phase 9: the wide-BVH loop (plain PyTorch) on the same geometry,
    # 256x256, one pass; 64x64 card against CPU
    t0 = time.time()
    host_wide = bench_scene(256, 256, DEPTH, builder=big, traversal="wide")
    wide_scene = host_wide.to(dev)
    drive_main_path("phase 9 wide", pt, tc, tp, wide_scene, card, set(),
                    width=256, height=256, n_pass=1)
    del wide_scene
    card_vs_cpu("phase 9 wide", pt,
                bench_scene(64, 64, DEPTH, builder=big, traversal="wide"), spp=2,
                max_depth=CHECK_DEPTH)
    log(f"phase 9 wide: {time.time() - t0:.2f} s")

    # ---- phase 10: the dense route (plain PyTorch) on a golden recipe
    t0 = time.time()
    host_dense = golden_cornell(WIDTH, HEIGHT)
    if trace_api._pick(host_dense) is not td:
        raise AssertionError("auto did not pick the dense route for 12 triangles")
    dense_scene = host_dense.to(dev)
    drive_main_path("phase 10 dense", pt, tc, tp, dense_scene, card, set(),
                    n_pass=1)
    del dense_scene
    card_vs_cpu("phase 10 dense", pt, golden_cornell(64, 64))
    log(f"phase 10 dense: {time.time() - t0:.2f} s")

    # ---- phase 11: the flat scene through B4 at 64x64 against the CPU
    # twins and against the cluster route's image of phase 4
    t0 = time.time()
    img_flat_packet = card_vs_cpu(
        "phase 11 packet", pt, bench_scene(64, 64, DEPTH, traversal="packet"),
        max_depth=CHECK_DEPTH)
    close = pixels_close(img_flat_packet, img_flat_cluster)
    log(f"phase 11 packet 64x64 8 spp depth {CHECK_DEPTH}: pixels within 1e-3 "
        f"of the cluster route's image: {close:.4f}")
    if close < 0.99:
        raise AssertionError(f"packet vs cluster route image: {close}")
    log(f"phase 11 packet: {time.time() - t0:.2f} s")

    # ---- phase 12: the kernel lab, each tool's kernels at its own size
    t0 = time.time()
    lab_rows = (lab_gather(card) + lab_prims(card) + lab_subvisit(card)
                + lab_cluster_cost(card, tc))
    if any(r["launches"] <= 0 for r in lab_rows):
        raise AssertionError("phase 12: a lab kernel was not launched by its "
                             "tool's main()")
    log(f"phase 12 kernel lab: {time.time() - t0:.2f} s")

    # ---- phase 13: the lab's traversal prototypes T2, T3, T4 (and B4 on
    # T3's and T4's rays)
    t0 = time.time()
    trav_rows = lab_proto_cluster(card) + lab_packet_walks(card, tp)
    if any(r["launches"] <= 0 for r in trav_rows):
        raise AssertionError("phase 13: a lab kernel was not launched by its "
                             "tool's main()")
    log(f"phase 13 traversal prototypes: {time.time() - t0:.2f} s")

    # ---- phase 14: textured shading and alpha shadows (B2 over the opaque
    # shadow pool), a scene assembled from a SceneDesc with its files
    t0 = time.time()
    opaque_rows = textured_phase(card, pt, tc, tp, trace_api, dev)
    log(f"phase 14 textured: {time.time() - t0:.2f} s")
    log(f"all phases: {time.time() - t_start:.1f} s")

    at = "hydracore_tpu/ops/traverse_cluster.py"
    b12 = ("B1 cluster traversal", "B2 cluster traversal")
    b3 = ("B3 cluster traversal", "B3 cluster traversal")
    b4 = ("B4 packet traversal", "B4 packet traversal")

    def counted(counts, prefix=""):
        return (counts[prefix + "closest_launches"],
                counts[prefix + "any_launches"])

    rows = (kernel_rows(b12, "flat pool Cp 384", CLUSTER_CU, f"{at}:576",
                        flat_recs, counted(flat_counts))
            + kernel_rows(b3, f"instanced Ci {host_inst.cl_map.shape[1]}",
                          CLUSTER_CU, f"{at}:394", inst_recs,
                          counted(inst_counts, "inst_"))
            + kernel_rows(b12, f"{P} chunks of 1024", CLUSTER_CU, f"{at}:663",
                          part_recs, counted(part_counts))
            + kernel_rows(b4, f"{host_pkt.wbvh_nodes.shape[0]} wide nodes, "
                          "unsorted rays", PACKET_CU,
                          "hydracore_tpu/ops/traverse_packet.py:204", pkt_recs,
                          counted(pkt_counts, "pkt_"))
            + opaque_rows + lab_rows + trav_rows)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
