"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's native code from the checkout (csrc/ -> the git-ignored
hydracore_tpu_torch/_build/, the compilers started together), then drives
four main paths of the MIS+NEE path tracer, a textured fifth (phase 14)
and a sixth through the last gates of the path tracer (phase 15),
render_passes at 1024x1024, depth 5, seed 777, each through its kernels,
then the other schedules of the path tracer (phase 16), light tracing and
the G-buffer (phase 17), bidirectional path tracing (phase 18),
Metropolis light transport (phase 19) and the front ends (phase 20):
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
B4 against the CPU twins and the cluster route's image. The two other
routes run too: the wide-BVH loop (plain PyTorch) on the packet path's
scene at 256x256 and the dense route (csrc/traverse_dense.cu) on the golden
cornell box, each card against CPU; the dense kernel also against its
plain version on the card, every word equal in float32 and float64, on
the main path's 2^20-ray wavefronts over the benchmark's Cornell box (88
slots), both timed ("kernels" rows D). One pass
of each kernel path runs under torch.profiler.
Phase 12 is the kernel lab (hydracore_tpu_torch/tools/): the kernels of
tools T7 (row gathers, S 4096, R 262,144, 16 iterations; the window path
and the direct kernel, also bit for bit on T7's adversarial inputs, any NaN
matching any NaN), T6 (ten probes
on (64, 128)), T5 (sub-visits, G 512, V 64, C 384) and T1 (the cluster
kernel's cost split on bench_scene at 512x512, every variant and B1 as
"full") held against their plain versions on the card at the tools' own
sizes and timed with them (T7 also against one embedding_bag call, T6's
probes where one PyTorch call computes them against that call, each
probe, the launch floor and the call timed in turns over graphs of the
same length; T6 also bit for bit on k8's
adversarial inputs: a NaN, a row of -inf, ties of -0.0 and +0.0; T5 every
output word bit for bit, also on its adversarial inputs, and its profiling
build's counts and the time its SASS permits at the issue rate), then each
tool's main() run with its launch counters set to 0 just before and read
just after; main() times each lab kernel as the mean of a CUDA graph of
its calls, without the host's issue time (T6 beside the launch floor, an
empty kernel over a graph of the same length).
Phase 13 is the lab's traversal prototypes, each tool's main() first, with
its launch counter set to 0 just before and read just after, and its
outputs and times then used by the checks: T2 (the dense cluster
traversal over synthetic clusters, 262,144 rays, C 256) in the tool's eight
jobs, kernel against plain version bit for bit, each job's time beside its
bound, the MXU job without a hit, and once more with random plane columns,
where the Plucker test must hit; its adversarial inputs (ties within and
across clusters, an empty list, lists of 0-15 entries, Cp 384, R_BLK 1024
with plane columns) in every mode, bit for bit; its SASS's instructions a
position and a lane and the time that they permit at the issue rate;
T3 and T4 (packets of 128 and 1024 rays) on bench_scene at 512x512 with the
tools' coherent and incoherent rays, each against its plain version on
16,384 rays from the middle of the set (t, u, v, slot, visits equal), the
packets at MAX_VISITS logged; each on its adversarial inputs bit for bit
(the plain walks of the MAX_VISITS cases on the CPU, in a worker process
started with phase 12), its profiling build's counts, packet-work bound and
the time its SASS permits at the issue rate; B4 on the same rays against
both (hit masks, t on hits, slots on >= 99.9%), the three packet sizes
timed side by side against one bound.
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
6, 9 and 11 run at depth CHECK_DEPTH, phase 14's and 15's at the scene's
depth.
Phase 15 is the path tracer's last gates: a SceneDesc of bench_builder's
geometry at full size (gates_desc) through assemble, whose large sphere is
an SSS medium, whose glass sphere holds Beer fog, whose floor is an
ao_dirt procedural texture fed by AO probes, back wall falloff and left
wall hexaplanar over three texture files; B1 against its twin on the
primary wavefront and a first bounce with rays inside the medium, B2
against its twin on the AO-probe wavefront of the last 2^18-ray band (4 x
2^18 rays, built by the path tracer's own ao_rays; occlusion equal), the main
path (B1, B2 and B2 on AO probes, ao_any_launches, > 0) and a profile,
the direct and indirect layers at 1024^2, one pass each, summing to the
color pass within 1e-4, and 64x64 card images against the CPU twins on the
cluster and the packet route.
Phase 16 is the path tracer's other schedules: the regenerating wavefront
(render_passes(regen=True), integrators/pt_regen.py) against the pass loop
on the flat scene and an open sky-lit scene (N_PASS passes) and on phase
15's gates scene (1 pass), each timed with its launch counters, profiled,
and run once more to read the live share of every traced segment (regen
also its iterations and host syncs); images equal by the image rule, rays
within 2%; B1 and B2 against their twins on a regen segment and its shadow
rays; render_pass at 1024^2 against render_passes(n_pass=1); production
sampling at spp 16 against render at spp 16, and one tile at K = 64 (a
2^20-ray wavefront: its time, launches and peak memory, B1 and B2 against
their twins on its primary, bounce and shadow wavefronts), the same tile of
the gates scene (AO probes) and of the textured scene (the alpha layer)
against four K = 16 tiles of the same samples; the gates scene
with its back wall's falloff given as C source (FALLOFF_C, compiled by
ops/proctex_c): one 1024^2 pass, its launches against the stdlib's, 64x64
card against the CPU and against the stdlib texture; 64x64 card images of
regen, production and render_pass against the CPU. Its four "kernels"
rows follow phase 15's.
Phase 17 is light tracing, the G-buffer and adaptive sampling
(lt_gbuffer_phase): render_lt on the flat scene (2^20 light paths a pass,
N_PASS passes: DEPTH - 1 unsorted 2^20-ray wavefronts of light rays through
B1 and as many camera connections through B2 a pass) and on phase 8's packet
scene (B4 in both modes, no packet at MAX_VISITS), each timed with its
launch counters (Mpaths/s, Mrays/s from the live rays counted in the
timed run, peak memory) and profiled; B1 and B2 against their twins on LT's
first light and camera-connection wavefronts, B4 likewise on the whole
2^20-ray wavefronts; eval_gbuffer (4 subsamples, each a 2^20-ray wavefront
of eye rays and one of shadow rays, the shadow rays put into coherence
order) on the flat scene (B1, B2) and on phase 6's instanced scene
(B3 in both modes), each against its twins on the first subsample's
wavefronts, the instanced inst_id equal to the flattened assembly's on
>= 99.9% of pixels; render_adaptive on the flat scene at spp 8 -> 16 in tiles
of 131,072 pixels (2^20 rays a wavefront; one base round, so no pixel is
noisy), again in the default tiles of 16,384, and at 256^2, spp 33 -> 40
(two base rounds, some pixels topped up); off the path, B1 on LT's light
wavefront sorted into coherence order against the rays as they come;
64x64 card against CPU for LT, every G-buffer layer and render_adaptive.
Its "kernels" rows follow phase 16's.
Phase 18 is bidirectional path tracing (bidir_phase): render_bdpt (full
SBDPT) and render_ibpt (3-way) on the flat scene (N_PASS passes of 2^20
lanes: DEPTH camera and DEPTH - 1 light wavefronts through B1, 14 (full) or
8 (3-way) any-hit wavefronts of NEE, light-vertex-to-camera and inner
connections through B2 a pass), render_bdpt on sky_scene (the env
strategies) and on phase 8's packet scene (B4, no packet at MAX_VISITS),
render_ibpt on phase 6's instanced scene (B3), each timed with its launch
counters (exact counts a pass), Msamples/s, Mrays/s from the live rays of
the timed run, peak memory, and profiled; B1/B2, B4 and B3 against their
twins on BDPT's first camera (unsorted), light, NEE, t = 1 and inner
wavefronts; the statistical checks of the CPU bidirectional tests at their
own counts at 16x16 (the port's BDPT per strategy against the port's
OracleSBDPT, whose eleven images worker processes make meanwhile, and
SBDPT/IBPT against PT), and the per-strategy images of full and 3-way at
64x64 card against CPU. Its "kernels" rows follow phase 17's.
Phase 19 is Metropolis light transport (metropolis_phase): render_mlt
(PSSMLT over the path tracer's legacy mode, 2^20 chains) on the flat scene
(N_PASS passes of MLT_MUT mutations, the first a burn-in pass: DEPTH
closest-hit wavefronts through B1, the first in chain order, the rest
sorted inside the call, and DEPTH - 1 sorted shadow wavefronts through B2 a
mutation) and on phase 8's packet scene (B4, one pass, no packet at
MAX_VISITS), render_mmlt (the depth groups' chains in one merged SBDPT
wavefront of 2^20 lanes a mutation, after 16 probe rounds) on the flat
scene (N_PASS passes) and on phase 6's instanced scene (B3, one pass):
each timed with its launch counters (exact counts), Mmutations/s over the
mutation loop, Mrays/s from the live rays of the timed run, acceptance,
b or b_k and the allocation, the start's or burn-in's share, host syncs,
peak memory, one mutation profiled; B1/B2, B4 and B3 against their twins
on the first mutation's camera wavefront (chain order) and first sorted
bounce and shadow wavefronts (MLT) or first connection wavefront (MMLT);
one PSSMLT and one MMLT mutation at 64x64 on the card against the CPU
twins from one chain state (proposals, splats, accept decisions); and the
statistical checks of tests/test_mmlt.py and tests/test_oracle_mmlt.py that
the CPU tests leave out, at their own sizes (metropolis_statistics: the
bulb in a glass shell on the card, the others on the CPU twins in worker
processes meanwhile). Its "kernels" rows follow phase 18's.
Phase 20 is the front ends (front_ends_phase), on statefile libraries
written here (front_library: scene/library.py:write_library's
scene with a field of small boxes, the cluster route over a flat pool, and
one with 20 spheres of 25,280 triangles, which load_scene instances): the
CLI (app/cli.py, in this process) renders PT at 1024x1024, 16 spp in two
chunks of 8, held through its checkpoint against render_passes over the
same passes, its printed Msamples/s and wall time logged beside
render_passes' and the host time a pass adds when every chunk writes its
PNG, checkpoint and shared-image delta; then every route and flag at
256x256 (raytracing, lt, sbdpt, ibpt, mlt, mmlt, offline_pt, multichip on
an NCCL world of 1, regen, layer direct, evalgbuffer, both denoise
filters, stat; -multichip with -method lt; PT on the instanced library),
each with its launch counters set to 0 just before and read just after
(B1/B2, or B3 on the instanced library, must move); 8 + 8 passes resumed
from a checkpoint against a straight 16; a run stopped by the exitnow
mailbox; two CLI processes (python -m hydracore_tpu_torch.app.cli, seeds 1
and 2) adding into one shared image; render_with_plugin with the pinhole
plugin and one InteractiveSession step of every method on the packet
route (B4), each timed, and make_server's /frame.png and /status; and
64x64 card against CPU for the CLI's PT (the checkpoint's float sum) and
the pinhole plugin. It adds no "kernels" row: no kernel is new.
"python3 chip_smoke.py --lab" runs phase 1 and then phases 12 and 13
alone, and prints their "kernels" line and the card's line.
Any failed check raises: the script then exits non-zero and prints no
result line. On success the last line is the JSON result
{"ok": true, "device": {...}}; the line before it the card's name and power
limit; before that a "kernels" JSON line.
"""
from __future__ import annotations

import dataclasses
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
from hydracore_tpu_torch.utils import lab, spans  # noqa: E402

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
# length of the AO probes of phase 15's floor (a quarter of the box)
AO_LENGTH = 1.0
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
    """Box tests the two-level walk needs: for each active ray the upper
    boxes its own walk votes on (B1/B2: every group; B3: the tree's root
    and the children of each node the ray enters) and the members (cluster,
    instance-cluster) of each upper box it enters, all before its final t
    (walk_counts over blocks of one ray)."""
    from hydracore_tpu_torch.ops.traverse_cluster import (BIG, scene_pool,
                                                          walk_counts)

    flat = rays.reshape(-1, 8)
    act = flat[:, 7] > 0
    te = torch.where(t_end <= -BIG * 0.5, flat[:, 6], t_end)
    votes, members = walk_counts(flat[:, None], scene_pool(scene), te)
    return int(((votes + members) * act).sum())


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


def profile_pass(pt, scene, card: str, tag: str, run=None,
                 what: str = "one pass") -> dict | None:
    """torch.profiler over one 1024x1024 pass (or the call `run`): wall
    time, device busy time and the kernels that take it, largest first. The
    profiler records the device's activity alone, and its raw kineto events
    are summed here by name: recording the host's events and reading
    key_averages() give the same device times and take many times the
    pass's own wall time. Returns {"wall_ms", "busy_ms", "launches"}, None
    when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    if run is None:
        def run():
            pt.render_passes(scene, 200, SEED, n_pass=1, max_depth=DEPTH,
                             device=scene.tri_attr.device)
    t_all = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
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
        return None
    launches = sum(n for _, n in by_name.values())
    log(f"{tag} profile, {what}: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%), "
        f"{launches} kernel launches [{card}] "
        f"(the profiler's own time {time.time() - t_all - wall / 1e3:.2f} s)")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"{tag}   {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:5d} {name[:90]}")
    return {"wall_ms": wall, "busy_ms": busy, "launches": launches}


def wavefronts(pt, scene, sort: bool = True, light_row: int = 0,
               rays=None):
    """The main path's three kinds of wavefront on `scene`, 2^18 rays each:
    every 4th primary ray of the frame in Morton order (spread over the
    whole image), or the primary rays `rays` = (origins, directions) as
    given, cosine-sampled bounce rays off their hit points (about
    the viewer-facing normal, or on an SSS material about its reverse, so
    those rays start inside the medium as the path tracer's do once they
    cross the boundary) and shadow rays to uniform points on the rect light
    (light row `light_row`). With
    `sort` the last two come in coherence order, as the path tracer sends
    them to the cluster kernels; without, in the primaries' order with the
    dead rays in place, as it sends them to every other route. Returns
    [(name, origins, directions, t_max, active, any_hit_mode)]."""
    from hydracore_tpu_torch.ops.trace_api import closest_hit, coherence_order
    from hydracore_tpu_torch.scene import materials as MC
    from hydracore_tpu_torch.utils.math3d import (make_orthonormal_basis,
                                                  offs_ray_pos)

    dev = scene.tri_attr.device
    if rays is None:
        ray_o, ray_d, _, _ = pt.primary_rays(scene, [0], SEED)
        ray_o, ray_d = ray_o[::4].contiguous(), ray_d[::4].contiguous()
    else:
        ray_o, ray_d = rays
    t, tri, u, v = closest_hit(scene, ray_o, ray_d)
    hit = tri >= 0
    pos, n, ng, _, mat, _, _ = pt.compute_hit(scene, tri, u, v, ray_o, ray_d, t)
    inside = hit & (scene.mat_attr[mat.long(), MC.MA_SSS_TRANSMISSION] > 0)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    rnd = torch.rand((ray_o.shape[0], 4), generator=g).to(dev)
    ns = torch.where((n * ray_d).sum(-1, keepdim=True) < 0, n, -n)
    ngs = torch.where((ng * ray_d).sum(-1, keepdim=True) < 0, ng, -ng)
    ns = torch.where(inside[:, None], -ns, ns)  # into an SSS medium
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
    equal), optionally against the flat-pool kernel on
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
        # the twin's time and (from its warm-up call) its result
        plain, (tt, stw) = lab.time_ms(lambda: tc.cluster_traverse_plain(
            rays, any_hit_mode=any_hit_mode, **twin_pool), 1, rays.device,
            result=True)
        hk, ht = sk >= 0, stw >= 0
        if any_hit_mode:
            agree = float((hk == ht).float().mean())
            err = float((hk.float() - ht.float()).abs().max())
            log(f"{tag} {name}: {n_rays} rays, occluded {int(hk.sum())}, "
                f"occlusion agrees with the twin on {agree:.6f}")
            if not torch.equal(hk, ht):
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
            return [x.float() for x in tc.walk_counts(rays, pool, t)]
        N = scene.lvl_start.numel() - 1
        what = (f"{int(scene.lvl_start[-1])} clusters under {N} upper boxes "
                f"(a walk over every position: "
                f"{scene.cl_bounds_oct.numel() // 64})")
        (mv, mm), (lv, lm) = walk(), walk(tk.reshape(-1))
        most, least = mv + mm, lv + lm
        visits = block_visits(scene, rays, tk.reshape(-1)).float()
        log(f"{tag} {name}: positions a block walks, of {what}: at most "
            f"mean {float(most.mean()):.1f}, largest {int(most.max())}; at "
            f"least mean {float(least.mean()):.1f}, largest "
            f"{int(least.max())}; Woop blocks a block needs: mean "
            f"{float(visits.mean()):.1f}, largest {int(visits.max())}")
        if scene.cl_map is not None:
            # B3's upper level: votes a block on the card (the kernel's
            # counter) against the twin's bounds and the flat vote's N
            with spans.recording():
                tc.cluster_traverse(rays, any_hit_mode=any_hit_mode, **pool)
            got = spans.take().counters[tc.VOTES_COUNTER]
            log(f"{tag} {name}: upper votes a block on the card "
                f"{got / rays.shape[0]:.1f} (the tree walk at least "
                f"{float(lv.mean()):.1f}, at most {float(mv.mean()):.1f}, "
                f"largest {int(mv.max())}; a flat vote on every instance: "
                f"{N})")
            if not int(lv.sum()) <= got <= int(mv.sum()):
                raise AssertionError(f"{tag} {name}: {got} upper votes")
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


TC_COUNTERS = ("closest_launches", "any_launches", "opaque_any_launches",
               "ao_any_launches", "inst_closest_launches", "inst_any_launches")
COUNTERS = TC_COUNTERS + ("pkt_closest_launches", "pkt_any_launches",
                          "dense_closest_launches", "dense_any_launches")


def launch_counts(tc, tp) -> dict:
    """Every wrapper's launch count: B1, B2, B2 over the opaque shadow pool,
    B2 on the AO probes, B3 (closest, any), B4 (closest, any), the dense
    kernel (closest, any)."""
    from hydracore_tpu_torch.ops import traverse_dense as td

    out = {k: getattr(tc, k) for k in TC_COUNTERS}
    out.update(pkt_closest_launches=tp.closest_launches,
               pkt_any_launches=tp.any_launches,
               dense_closest_launches=td.closest_launches,
               dense_any_launches=td.any_launches)
    return out


def reset_launch_counts(tc, tp) -> None:
    """Every counter of launch_counts set to 0."""
    from hydracore_tpu_torch.ops import traverse_dense as td

    tc.reset_launch_counts()
    tp.reset_launch_counts()
    td.reset_launch_counts()


def timed_call(tag, tc, tp, run, card, expect: dict, warm=None) -> tuple:
    """warm() (else run()) once as a warm-up, then run() once timed with the
    launch counters set to 0 just before and read just after, and the
    card's peak memory above what was allocated before. `expect` gives
    each counter that must be > 0 its exact count, or None for any count
    > 0; every other counter must stay 0. Returns (result, seconds,
    counts, peak bytes)."""
    dev = torch.device("cuda")
    (warm or run)()
    torch.cuda.synchronize()
    reset_launch_counts(tc, tp)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    out = run()
    torch.cuda.synchronize()
    dt = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    counts = launch_counts(tc, tp)
    for k, v in counts.items():
        want = expect.get(k, 0)
        if (v > 0) != (k in expect) or (want and v != want):
            raise AssertionError(f"{tag}: launch counts {counts}, expected "
                                 f"{expect}")
    return out, dt, counts, peak


def packet_peak(tag, tp, run) -> None:
    """run() once more, untimed, with every B4 launch's visit counts read
    through the wrapper's hook: no packet may reach MAX_VISITS."""
    peaks = []
    tp.visits_hook = lambda n: peaks.append(n.max())
    try:
        run()
    finally:
        tp.visits_hook = None
    peak = max(int(p) for p in peaks)
    log(f"{tag}: the busiest packet of {len(peaks)} launches popped {peak} "
        f"entries (MAX_VISITS {tp.MAX_VISITS})")
    if not 0 < peak < tp.MAX_VISITS:
        raise AssertionError(f"{tag}: a packet reached MAX_VISITS ({peak})")


def drive_main_path(tag, pt, tc, tp, scene, card, expect: set,
                    width: int = WIDTH, height: int = HEIGHT,
                    n_pass: int = N_PASS) -> dict:
    """One warm-up pass, then n_pass passes through timed_call: `expect`
    names the counters that must be > 0; every other counter must stay 0.
    No packet of B4 may reach MAX_VISITS."""
    dev = scene.tri_attr.device

    def passes(base=0, n=n_pass):
        return pt.render_passes(scene, base, SEED, n_pass=n, max_depth=DEPTH,
                                device=dev)

    (img, rays_traced), dt, counts, _ = timed_call(
        tag, tc, tp, passes, card, dict.fromkeys(expect),
        warm=lambda: passes(100, 1))
    rays_traced = int(rays_traced)
    log(f"{tag} main path: launches {counts}")
    if not bool(torch.isfinite(img).all()) or float(img.sum()) <= 0.0:
        raise AssertionError(f"{tag}: image is not finite and non-zero")
    if tuple(img.shape) != (height, width, 3):
        raise AssertionError(f"{tag}: image shape {tuple(img.shape)}")
    if counts["pkt_closest_launches"] > 0:
        packet_peak(f"{tag} main path", tp, passes)
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


def kernel_code(tag, src: str) -> dict:
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
    neither). Returns {mangled name: the kernel's own code, a list of
    (address, opcode, operands)}."""
    from hydracore_tpu_torch.utils import build

    recs = {}
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
        recs[fn] = own
    return recs


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
        reset_launch_counts(tc, tp)
        card_vs_cpu("phase 14 packet", pt, small_pkt)
        pkt = launch_counts(tc, tp)
        log(f"phase 14 packet 64x64: launches {pkt}")
        if (pkt["pkt_closest_launches"] == 0 or pkt["pkt_any_launches"] != 0
                or any(pkt[k] for k in TC_COUNTERS)):
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


def gates_desc(lib_dir: str, width: int, height: int):
    """A SceneDesc of bench_builder's geometry at full size whose materials
    take the path tracer's last gates: the 25,280-triangle sphere an SSS
    medium (<sss>: density, RGB absorption, scattering, phase 0.3,
    transmission 0.8), the 960-triangle glass sphere Beer fog (fog_color,
    fog_multiplier), the floor an ao_dirt procedural texture with an 'up'
    AO hemisphere of AO_LENGTH, the back wall falloff, the left wall
    hexaplanar over three 256^2 texture files written to lib_dir; the rect
    light of the golden box."""
    from hydracore_tpu_torch.scene import statefile as sf
    from hydracore_tpu_torch.scene.procedural import SceneBuilder
    from hydracore_tpu_torch.scene.vsgf import make_rect_mesh

    rng = np.random.default_rng(SEED + 15)
    textures = {}
    for tid in (1, 2, 3):
        y, x = np.mgrid[0:256, 0:256].astype(np.float32) / 256.0
        img = np.ones((256, 256, 4), np.float32)
        img[..., :3] = 0.3 + 0.5 * np.stack(
            [np.sin((tid + 3) * x), np.cos((tid + 5) * y),
             rng.random((256, 256))], -1) ** 2
        name = f"tri{tid}.image4ub"
        size = _write_image(os.path.join(lib_dir, name), img)
        textures[tid] = sf.TextureDesc(id=tid, name=name, loc=name, offset=0,
                                       bytesize=size)
    textures[4] = sf.TextureDesc(id=4, name="ao_dirt", loc=None, offset=0,
                                 bytesize=0, proc_name="ao_dirt", ao_type=1,
                                 ao_length=AO_LENGTH)
    textures[5] = sf.TextureDesc(id=5, name="falloff", loc=None, offset=0,
                                 bytesize=0, proc_name="falloff")
    textures[6] = sf.TextureDesc(id=6, name="hexaplanar", loc=None, offset=0,
                                 bytesize=0, proc_name="hexaplanar")

    def proc(tid, args):
        a = "".join(f'<arg type="{t}" val="{v}"/>' for t, v in args)
        return f'<texture id="{tid}" type="texref_proc">{a}</texture>'

    def diffuse(rgb, tex=""):
        return f'<diffuse brdf_type="lambert"><color val="{rgb}"/>{tex}</diffuse>'

    mats = {
        0: diffuse("1 1 1", proc(4, [("float3", "0.05 0.04 0.03"),
                                     ("float3", "0.8 0.78 0.75")])),
        1: diffuse("0.65 0.65 0.65"),
        2: diffuse("1 1 1", proc(5, [("float3", "0.9 0.3 0.15"),
                                     ("float3", "0.15 0.3 0.9")])),
        3: diffuse("1 1 1", proc(6, [("sampler2D", "1"), ("sampler2D", "2"),
                                     ("sampler2D", "3"), ("sampler2D", "3"),
                                     ("sampler2D", "2"), ("sampler2D", "1"),
                                     ("float", "4"), ("float", "0.7")])),
        4: diffuse("0.12 0.55 0.18"),
        5: diffuse("0.3 0.2 0.15") + '<sss><density val="1.2"/><absorption '
           'val="0.5 0.15 0.05"/><scattering val="3"/><phase val="0.3"/>'
           '<transmission val="0.8"/></sss>',
        6: '<transparency><color val="1 1 1"/><glossiness val="1"/><ior '
           'val="1.5"/><fog_color val="0.9 0.5 0.3"/><fog_multiplier '
           'val="1.5"/></transparency>',
    }
    materials = {k: ET.fromstring(f'<material id="{k}" type="hydra_material">'
                                  f'{v}</material>') for k, v in mats.items()}
    materials[7] = ET.fromstring(
        '<material id="7" type="hydra_material" light_id="0"><emission>'
        '<color val="12 12 12"/><multiplier val="1"/></emission></material>')
    light = ET.fromstring(
        '<light id="0" type="area" shape="rect" distribution="diffuse" '
        'mat_id="7"><size half_length="0.5" half_width="0.5"/><intensity>'
        '<color val="12 12 12"/><multiplier val="1"/></intensity></light>')
    walls = SceneBuilder()
    walls.add_box_interior(2.0, 0, 1, 2, 3, 4)
    skin = SceneBuilder()
    skin.add_sphere([-0.6, -1.1, -0.4], 0.9, 5, n_seg=160, n_ring=80)
    glass = SceneBuilder()
    glass.add_sphere([0.9, -1.5, 0.7], 0.5, 6)
    m_light = np.eye(4, dtype=np.float32)
    m_light[1, 3] = 1.95
    eye = np.eye(4, dtype=np.float32)
    instances = [sf.InstanceDesc(mesh_id=k, matrix=eye) for k in range(3)]
    instances.append(sf.InstanceDesc(mesh_id=3, matrix=m_light, light_id=0,
                                     linst_id=0))
    cam = sf.CameraDesc()
    cam.position = np.array([0, 0, 5.6], np.float32)
    cam.look_at = np.zeros(3, np.float32)
    return sf.SceneDesc(
        lib_dir=lib_dir, textures=textures, materials=materials,
        lights={0: light}, camera=cam,
        settings=sf.RenderSettings(width=width, height=height,
                                   trace_depth=DEPTH),
        meshes={0: mesh_of(walls), 1: mesh_of(skin), 2: mesh_of(glass),
                3: make_rect_mesh(0.5, 0.5, 7)},
        mesh_light_id={}, instances=instances,
        light_instances=[sf.LightInstanceDesc(light_id=0, matrix=m_light)])


def ao_wavefront(pt, tc, trace_api, scene):
    """The AO probes of the last band's primary hits (2^18 rays, the bottom
    right quarter of the frame in Morton order, where the floor is; so
    AO_PROBES * 2^18 probe rays), built by pt.ao_rays from the rows of the
    hit materials and the path tracer's own DG_AO uniforms at depth 0,
    sorted and packed as trace_api.ao_any_hit packs them. Returns (blocks,
    active probe rays)."""
    from hydracore_tpu_torch.scene import materials as MC

    R = scene.camera.width * scene.camera.height
    band = (max(R - pt.MEGABLOCK, 0), R)
    ray_o, ray_d, sidx, _ = pt.primary_rays(scene, [0], SEED, band)
    t, tri, u, v = trace_api.closest_hit(scene, ray_o, ray_d)
    pos, n, ng, _, mat, _, _ = pt.compute_hit(scene, tri, u, v, ray_o, ray_d, t)
    row = scene.mat_attr[mat.long()]
    ao_t = row[:, MC.MA_AO_TYPE].to(torch.int32)
    need = (tri >= 0) & (ao_t > 0)
    o, d, t_max, act = pt.ao_rays(pos, n, ng, ao_t, row[:, MC.MA_AO_LENGTH],
                                  need, pt.rng.rand4(sidx, 0, pt.DG_AO, SEED))
    perm = trace_api.coherence_order(scene, o, d, act)
    blocks, _ = tc._to_blocks(o[perm], d[perm], t_max[perm], act[perm],
                              tc.R_BLK)
    return blocks, int(act.sum())


def gates_phase(card, pt, tc, tp, trace_api, dev) -> list:
    """Phase 15: the scene of gates_desc through assemble (its texture
    files written under hydracore_tpu_torch/_build/ and removed after,
    its procedural textures registered and the registry cleared after):
    B1 against its twin on the primary wavefront and a first bounce with
    rays inside the SSS medium, B2 against its twin on the AO-probe
    wavefront of the last band (occlusion equal), the main path at 1024^2
    (B1, B2 and B2 on AO probes > 0) and a profile, the direct and indirect
    layers at 1024^2, one pass each, summing to the color pass within
    1e-4, and 64x64 card images against the CPU twins on the cluster and
    the packet route at depth DEPTH. Returns the two "kernels" rows: B1 on
    the gates scene (its bounce rays off the SSS sphere start inside it,
    wavefronts), B2 on the AO probes."""
    from hydracore_tpu_torch.ops import proctex
    from hydracore_tpu_torch.scene.scene import assemble
    from hydracore_tpu_torch.utils.build import BUILD_DIR

    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = tempfile.mkdtemp(prefix="gates_", dir=BUILD_DIR)
    proctex.clear_registry()
    try:
        t0 = time.time()
        desc = gates_desc(lib, WIDTH, HEIGHT)
        host = assemble(desc)
        st = host.settings
        gates = ("has_sss", "has_fog", "has_proc_tex", "has_proc_ao")
        if not all(getattr(st, g) for g in gates):
            raise AssertionError(f"phase 15: gates {[getattr(st, g) for g in gates]}")
        if trace_api._pick(host) is not tc:
            raise AssertionError("phase 15: the scene does not take the cluster "
                                 "route")
        log(f"phase 15 gates scene: {host.num_triangles} triangles, "
            f"{real_boxes(host).shape[1]} clusters (Cp {host.cl_tris.shape[0]}), "
            f"{proctex.num_proc_tex()} procedural textures registered, "
            f"assembled in {time.time() - t0:.2f} s")
        scene = host.to(dev)
        b1 = check_kernels("phase 15 gates", tc, scene,
                           cluster_cases(tc, wavefronts(pt, scene))[:2], card)
        blocks, n_ao = ao_wavefront(pt, tc, trace_api, scene)
        log(f"phase 15 gates AO probes: {n_ao} of "
            f"{blocks.shape[0] * blocks.shape[1]} probe rays active")
        if n_ao < blocks.shape[0] * blocks.shape[1] // 64:
            raise AssertionError(f"phase 15: {n_ao} active AO probe rays")
        ao = check_kernels("phase 15 gates", tc, scene,
                           [("AO probes", blocks, True)], card)["any"][0]
        del blocks
        log(f"phase 15 assembly and kernel checks: {time.time() - t0:.2f} s")

        t0 = time.time()
        counts = drive_main_path("phase 15 gates", pt, tc, tp, scene, card,
                                 {"closest_launches", "any_launches",
                                  "ao_any_launches"})
        profile_pass(pt, scene, card, "phase 15 gates")
        layers = {}
        for layer in ("color", "direct", "indirect"):
            s = dataclasses.replace(scene, settings=dataclasses.replace(
                scene.settings, render_layer=layer))
            tl = time.time()
            layers[layer], _ = pt.render_passes(s, 0, SEED, n_pass=1,
                                                max_depth=DEPTH, device=dev)
            torch.cuda.synchronize()
            log(f"phase 15 gates layer {layer}: one pass in "
                f"{time.time() - tl:.3f} s, mean {float(layers[layer].mean()):.5f}")
        err = float((layers["direct"] + layers["indirect"]
                     - layers["color"]).abs().max())
        share = float(layers["direct"].sum() / layers["color"].sum())
        log(f"phase 15 gates layers: |direct + indirect - color| <= {err:.3e} "
            f"at {WIDTH}x{HEIGHT} (direct {share:.4f} of the color image's "
            "energy)")
        if not err <= 1e-4:
            raise AssertionError(f"phase 15: layers sum to color within {err}")
        if not 0.01 < share < 0.99:
            raise AssertionError(f"phase 15: a layer is empty ({share})")
        del scene, layers
        log(f"phase 15 main path and layers: {time.time() - t0:.2f} s")
        t0 = time.time()
        card_vs_cpu("phase 15 cluster", pt, assemble(desc, 64, 64), spp=4)
        reset_launch_counts(tc, tp)
        card_vs_cpu("phase 15 packet", pt,
                    assemble(desc, 64, 64, traversal="packet"), spp=4)
        pkt = launch_counts(tc, tp)
        log(f"phase 15 packet 64x64: launches {pkt}")
        if (pkt["pkt_closest_launches"] == 0 or pkt["pkt_any_launches"] == 0
                or any(pkt[k] for k in TC_COUNTERS)):
            raise AssertionError(f"phase 15 packet: launches {pkt}")
        log(f"phase 15 64x64 images: {time.time() - t0:.2f} s")
    finally:
        shutil.rmtree(lib, ignore_errors=True)
        proctex.clear_registry()
    return kernel_rows(
        ("B1 cluster traversal", "B2 cluster traversal on AO probes"),
        "gates scene", CLUSTER_CU, "hydracore_tpu/ops/traverse_cluster.py:576",
        {"closest": b1["closest"], "any": [ao]},
        (counts["closest_launches"], counts["ao_any_launches"]))


# the stdlib falloff's arithmetic (ops/proctex.py:falloff) as the C source
# of phase 16's back wall, in the translator's subset
FALLOFF_C = """
float4 prtex1_main(const SurfaceInfo* sHit, float3 color1, float3 color2,
                   _PROCTEXTAILTAG_)
{
  const float3 n = readAttr_ShadeNorm(sHit);
  const float cos_a = fabs(dot(n, hr_viewVectorHack));
  const float3 c = color1 * (1.0f - cos_a) + color2 * cos_a;
  return make_float4(c.x, c.y, c.z, 1.0f);
}
"""
# the raster-order production tile timed alone at K = 64: tile TILE of
# TILE_PIXELS pixels, render_production's default (at 1024^2 rows 512-527,
# across both spheres)
TILE, TILE_PIXELS = 32, 16384


class SegmentProbe:
    """For an untimed run: wraps closest_hit of integrators/pt.py and
    pt_regen.py and pt.py's any_hit (the NEE shadow rays) to record the
    share of live lanes of every closest-hit wavefront, and keeps the rays
    of the `keep`-th closest-hit call and of the shadow call after it."""

    def __init__(self, pt, regen, keep: int = 2):
        self.pt, self.regen, self.keep = pt, regen, keep
        self.shares, self.kept = [], {}

    def __enter__(self):
        pt, regen = self.pt, self.regen
        self.saved = (pt.closest_hit, regen.closest_hit, pt.any_hit)
        closest_hit, any_hit = pt.closest_hit, pt.any_hit

        def closest(scene, ray_o, ray_d, t_max=1e30, active=None,
                    kind="primary"):
            if len(self.shares) == self.keep:
                self.kept["closest"] = (ray_o.clone(), ray_d.clone(), t_max,
                                        active.clone(), kind)
            self.shares.append(float(active.float().mean()))
            return closest_hit(scene, ray_o, ray_d, t_max, active, kind)

        def shadow(scene, ray_o, ray_d, t_max, active=None):
            if "closest" in self.kept and "any" not in self.kept:
                self.kept["any"] = (ray_o.clone(), ray_d.clone(),
                                    t_max.clone(), active.clone())
            return any_hit(scene, ray_o, ray_d, t_max, active)

        pt.closest_hit = regen.closest_hit = closest
        pt.any_hit = shadow
        return self

    def __exit__(self, *exc):
        self.pt.closest_hit, self.regen.closest_hit, self.pt.any_hit = self.saved

    def cases(self, tc, tag: str):
        """The kept closest-hit and shadow wavefronts packed as the path
        packs them: [(name, ray blocks, any_hit_mode)]."""
        o, d, t_max, act, kind = self.kept["closest"]
        so, sd, st, sa = self.kept["any"]
        r_blk = tc.R_BLK_BOUNCE if kind == "bounce" else tc.R_BLK
        return [(f"{tag} segment", tc._to_blocks(o, d, t_max, act, r_blk)[0],
                 False),
                (f"{tag} shadow", tc._to_blocks(so, sd, st, sa, tc.R_BLK)[0],
                 True)]


def compare_schedules(tag, pt, regen, tc, tp, scene, card, expect: set,
                      n_pass: int) -> dict:
    """The pass loop (render_passes) and the regenerating wavefront
    (render_passes(regen=True), timed through render_passes_regen for its
    iterations and host syncs) on `scene` at 1024^2: each one warm-up
    call, one timed call with the launch counters set to 0 just before and
    read just after (`expect` > 0, the rest 0), one call under the
    profiler, one untimed call through SegmentProbe (the mean live share of
    a traced segment; for regen also the rays of its third segment). The
    images (per-sample means) agree by the image rule, the ray counters
    within 2%. Returns {schedule: record}."""
    dev = scene.tri_attr.device
    W, H = scene.camera.width, scene.camera.height
    out = {}
    for name, use_regen in (("pass loop", False), ("regen", True)):
        def run(base=100):
            return pt.render_passes(scene, base, SEED, n_pass=n_pass,
                                    max_depth=DEPTH, device=dev,
                                    regen=use_regen)
        run()
        torch.cuda.synchronize()
        reset_launch_counts(tc, tp)
        stats = {}
        t0 = time.time()
        if use_regen:
            img, rays = regen.render_passes_regen(scene, 0, SEED, n_pass=n_pass,
                                                  max_depth=DEPTH, device=dev,
                                                  stats=stats)
        else:
            img, rays = run(0)
        torch.cuda.synchronize()
        dt = time.time() - t0
        counts = launch_counts(tc, tp)
        for k, v in counts.items():
            if (v > 0) != (k in expect):
                raise AssertionError(f"{tag} {name}: launch counts {counts}")
        if not bool(torch.isfinite(img).all()) or float(img.sum()) <= 0.0:
            raise AssertionError(f"{tag} {name}: image not finite and non-zero")
        rays = int(rays)
        prof = profile_pass(pt, scene, card, f"{tag} {name}", run=run,
                            what=f"one call of {n_pass} passes")
        with SegmentProbe(pt, regen) as probe:
            run()
            torch.cuda.synchronize()
        share = sum(probe.shares) / len(probe.shares)
        samples = n_pass * W * H
        log(f"{tag} {name}: {W}x{H} depth {DEPTH} {n_pass} passes in "
            f"{dt:.3f} s: {samples / dt / 1e6:.4f} Msamples/s, "
            f"{rays / dt / 1e6:.4f} Mrays/s ({rays} rays); launches {counts}; "
            f"{len(probe.shares)} traced segments, live share {share:.4f}"
            + (f"; {stats['iterations']} iterations, {stats['host_syncs']} "
               "host syncs" if use_regen else "") + f" [{card}]")
        out[name] = {"img": img / n_pass, "rays": rays, "s": dt,
                     "counts": counts, "profile": prof, "share": share,
                     "stats": stats, "probe": probe}
    close = pixels_close(out["regen"]["img"], out["pass loop"]["img"])
    r_loop, r_regen = out["pass loop"]["rays"], out["regen"]["rays"]
    log(f"{tag}: regen against the pass loop: pixels within 1e-3 {close:.6f}, "
        f"rays {r_regen} / {r_loop} ({r_regen / r_loop - 1:+.4%})")
    if close < 0.99:
        raise AssertionError(f"{tag}: regen vs pass loop image: {close}")
    if abs(r_regen - r_loop) > 0.02 * r_loop:
        raise AssertionError(f"{tag}: regen vs pass loop rays {r_regen} / {r_loop}")
    return out


def twin_image(tag, fn) -> None:
    """fn(device) -> image on the card and on the CPU: >= 99% of pixels
    within 1e-3."""
    img_gpu = fn("cuda").cpu()
    t0 = time.time()
    img_cpu = fn("cpu")
    close = pixels_close(img_gpu, img_cpu)
    log(f"{tag} 64x64: pixels within 1e-3 of the CPU's image: {close:.4f} "
        f"(the CPU's render {time.time() - t0:.2f} s)")
    if close < 0.99:
        raise AssertionError(f"{tag}: card vs CPU image: {close} of pixels agree")


def production_tile(pt, tc, tp, scene, card) -> tuple:
    """Production on the flat scene: render_production at spp 16 (one
    round of K = 16, 64 tiles of 2^18 rays) against render at spp 16 by
    the image rule, both timed; one tile of K = 16 profiled; then tile
    TILE alone at the default K = 64, one 2^20-ray wavefront: timed, its
    launches and the card's peak memory for it, B1 and B2 against their
    twins on its primary, bounce and shadow wavefronts. Returns (the
    "kernels" records of B1 and B2, their launches in that tile)."""
    dev = scene.tri_attr.device
    W, H = scene.camera.width, scene.camera.height
    spp = 16
    reset_launch_counts(tc, tp)
    stats = {}
    t0 = time.time()
    prod = pt.render_production(scene, spp, seed=SEED, max_depth=DEPTH,
                                device=dev, stats=stats)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = launch_counts(tc, tp)
    t0 = time.time()
    ref = pt.render(scene, spp, seed=SEED, max_depth=DEPTH, device=dev)
    torch.cuda.synchronize()
    dt_ref = time.time() - t0
    close = pixels_close(prod, ref)
    rays = int(stats["rays"])
    log(f"phase 16 production: {W}x{H} spp {spp} ({stats['tiles']} tiles x "
        f"{stats['rounds']} round of K = {spp}) in {dt:.3f} s: "
        f"{spp * W * H / dt / 1e6:.4f} Msamples/s, {rays / dt / 1e6:.4f} "
        f"Mrays/s ({rays} rays), launches {counts}; render at spp {spp} in "
        f"{dt_ref:.3f} s ({spp * W * H / dt_ref / 1e6:.4f} Msamples/s); "
        f"pixels within 1e-3 of render's: {close:.6f} [{card}]")
    if close < 0.99:
        raise AssertionError(f"phase 16 production vs render: {close}")
    if not (counts["closest_launches"] > 0 and counts["any_launches"] > 0):
        raise AssertionError(f"phase 16 production: launches {counts}")
    n = TILE_PIXELS
    ids = torch.arange(TILE * n, (TILE + 1) * n, device=dev)
    profile_pass(pt, scene, card, "phase 16 production", what=f"one tile of "
                 f"{n} pixels x {spp} samples", run=lambda:
                 pt.render_tile_production(scene, ids, 0, SEED, spp, DEPTH))

    pt.render_tile_production(scene, ids, 0, SEED, 64, DEPTH)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts(tc, tp)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    tile = pt.render_tile_production(scene, ids, 0, SEED, 64, DEPTH)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) - base
    tile_counts = launch_counts(tc, tp)
    if not bool(torch.isfinite(tile).all()) or tuple(tile.shape) != (n, 3):
        raise AssertionError("phase 16 production: K = 64 tile")
    log(f"phase 16 production tile {TILE}, {n} pixels x K = 64 "
        f"({n * 64} rays a wavefront, {n * 64 // tc.R_BLK} blocks of "
        f"{tc.R_BLK}): {ms:.2f} ms, launches {tile_counts}, peak device "
        f"memory {peak / 2**20:.1f} MiB above the scene's [{card}]")
    profile_pass(pt, scene, card, "phase 16 production", what="one tile of "
                 f"{n} pixels x 64 samples", run=lambda:
                 pt.render_tile_production(scene, ids, 0, SEED, 64, DEPTH))
    # the same tile through B4, whose packet queue then takes 2^15 packets
    from hydracore_tpu_torch.scene.procedural import bench_scene
    pkt_scene = bench_scene(W, H, DEPTH, traversal="packet").to(dev)
    reset_launch_counts(tc, tp)
    t0 = time.time()
    tile_pkt = pt.render_tile_production(pkt_scene, ids, 0, SEED, 64, DEPTH)
    torch.cuda.synchronize()
    pkt_ms = (time.time() - t0) * 1e3
    pkt_counts = launch_counts(tc, tp)
    close = pixels_close(tile_pkt, tile)
    log(f"phase 16 production tile {TILE} on the packet route: {pkt_ms:.2f} ms "
        f"(first call), launches {pkt_counts}; pixels within 1e-3 of the "
        f"cluster route's tile: {close:.6f} [{card}]")
    if (close < 0.99 or pkt_counts["pkt_closest_launches"] == 0
            or any(pkt_counts[k] for k in TC_COUNTERS)):
        raise AssertionError(f"phase 16 packet tile: {close}, {pkt_counts}")
    del pkt_scene
    o, d, _ = pt._production_rays(scene, ids, 0, SEED, 64)
    raw = wavefronts(pt, scene, rays=(o, d))
    recs = check_kernels("phase 16 production 2^20", tc, scene,
                         cluster_cases(tc, raw), card)
    return recs, (tile_counts["closest_launches"], tile_counts["any_launches"])


def wide_tile(tag, pt, tc, tp, scene, card, expect: set) -> None:
    """Tile TILE of `scene` at the default K = 64, one 2^20-ray wavefront
    (on the gates scene up to 2^22 AO probes a bounce, on the textured
    scene the alpha layer at that width): one call, timed, with the launch
    counters set to 0 just before and read just after (`expect` > 0, the
    rest 0) and the card's peak memory above the scene's; against the same
    samples as four K = 16 tiles (pass_base 0, 16, 32, 48) by the image
    rule."""
    dev = scene.tri_attr.device
    n = TILE_PIXELS
    ids = torch.arange(TILE * n, (TILE + 1) * n, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts(tc, tp)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    tile = pt.render_tile_production(scene, ids, 0, SEED, 64, DEPTH,
                                     device=dev)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) - base
    counts = launch_counts(tc, tp)
    for k, v in counts.items():
        if (v > 0) != (k in expect):
            raise AssertionError(f"{tag} K = 64 tile: launches {counts}")
    if not bool(torch.isfinite(tile).all()) or tuple(tile.shape) != (n, 3):
        raise AssertionError(f"{tag} K = 64 tile: not finite or shape")
    t0 = time.time()
    parts = [pt.render_tile_production(scene, ids, 16 * r, SEED, 16, DEPTH,
                                       device=dev) for r in range(4)]
    torch.cuda.synchronize()
    ms16 = (time.time() - t0) * 1e3
    close = pixels_close(tile, sum(parts) / 4)
    log(f"{tag} production tile {TILE}, {n} pixels x K = 64 ({n * 64} rays "
        f"a wavefront): {ms:.2f} ms (first call), launches {counts}, peak "
        f"device memory {peak / 2**20:.1f} MiB above the scene's; four K = 16 "
        f"tiles {ms16:.2f} ms; pixels within 1e-3 of their mean: {close:.6f} "
        f"[{card}]")
    if close < 0.99:
        raise AssertionError(f"{tag} K = 64 tile vs four K = 16: {close}")


def sky_scene(width: int, height: int):
    """An open, sky-lit scene with short mean paths: bench_builder's GGX and
    glass spheres on a 12 x 12 diffuse ground under a uniform sky, no walls
    and no other light, behind bench_scene's camera: the upper half of the
    frame sees the sky at once and most bounces off the ground escape."""
    from hydracore_tpu_torch.scene.procedural import SceneBuilder, bench_scene

    b = SceneBuilder()
    ground = b.lambert([0.6, 0.6, 0.6])
    b.add_rect([0, -2.0, 0], [6, 0, 0], [0, 0, 6], ground, flip=True)
    ggx = b.add_material(refl_color=np.array([0.8, 0.7, 0.5], np.float32),
                         refl_dist=2, refl_alpha=0.25, refl_gloss=0.75)
    b.add_sphere([-0.6, -1.1, -0.4], 0.9, ggx, n_seg=160, n_ring=80)
    glass = b.add_material(transp_color=np.array([0.95] * 3, np.float32),
                           transp_gloss=1.0, transp_ior=1.5)
    b.add_sphere([0.9, -1.5, 0.7], 0.5, glass)
    b.sky([0.6, 0.7, 0.9])
    return bench_scene(width, height, DEPTH, builder=b)


def source_phase(card, pt, tc, tp, dev, gates_prof) -> None:
    """Phase 16's procedural-texture source: gates_desc with the back wall's
    falloff given as FALLOFF_C, a .c file written into the library.
    assemble compiles it (ops/proctex_c): one compiled entry in the
    registry, the stdlib falloff not bound. One 1024^2 pass on the card
    (launches against the stdlib scene's pass, `gates_prof`), its
    profile, 64x64 card against the CPU and against the stdlib scene's
    card image."""
    from hydracore_tpu_torch.ops import proctex
    from hydracore_tpu_torch.scene import statefile as sf
    from hydracore_tpu_torch.scene.scene import assemble
    from hydracore_tpu_torch.utils.build import BUILD_DIR

    lib = tempfile.mkdtemp(prefix="source_", dir=BUILD_DIR)
    proctex.clear_registry()
    try:
        with open(os.path.join(lib, "falloff.c"), "w") as f:
            f.write(FALLOFF_C)

        def desc_of(width, height, source: bool):
            desc = gates_desc(lib, width, height)
            if source:
                desc.textures[5] = sf.TextureDesc(
                    id=5, name="falloff", loc="falloff.c", offset=0,
                    bytesize=0, proc_name="falloff")
            return desc

        t0 = time.time()
        host = assemble(desc_of(WIDTH, HEIGHT, True))
        fns = [f for f, _ in proctex._REGISTRY]
        compiled = [f.__name__ for f in fns if f.__name__.startswith("proctex_")]
        log(f"phase 16 proc-tex source: registry {[f.__name__ for f in fns]}, "
            f"assembled in {time.time() - t0:.2f} s")
        if compiled != ["proctex_prtex1_main"] or proctex.falloff in fns:
            raise AssertionError(f"phase 16 source: registry {fns}")
        scene = host.to(dev)
        drive_main_path("phase 16 proc-tex source", pt, tc, tp, scene, card,
                        {"closest_launches", "any_launches",
                         "ao_any_launches"}, n_pass=1)
        prof = profile_pass(pt, scene, card, "phase 16 proc-tex source")
        if prof and gates_prof:
            log(f"phase 16 proc-tex source: {prof['launches']} launches a "
                f"pass against {gates_prof['launches']} with the stdlib "
                f"falloff ({prof['launches'] - gates_prof['launches']:+d})")
        del scene
        small = assemble(desc_of(64, 64, True))
        img_src = card_vs_cpu("phase 16 proc-tex source", pt, small, spp=4)
        proctex.clear_registry()
        img_std = pt.render(assemble(desc_of(64, 64, False)), spp=4,
                            seed=SEED, device="cuda").cpu()
        close = pixels_close(img_src, img_std)
        log(f"phase 16 proc-tex source 64x64: pixels within 1e-3 of the "
            f"stdlib falloff's card image: {close:.4f}")
        if close < 0.99:
            raise AssertionError(f"phase 16 source vs stdlib: {close}")
    finally:
        shutil.rmtree(lib, ignore_errors=True)
        proctex.clear_registry()


def schedules_phase(card, pt, tc, tp, dev) -> list:
    """Phase 16: the path tracer's other schedules at 1024^2, depth DEPTH.
    The regenerating wavefront against the pass loop on the flat scene and
    the open sky-lit scene of sky_scene (N_PASS passes) and on phase 15's
    gates scene (1 pass: fog, SSS and the AO probes ride the regen state),
    B1 and B2 against their twins on a regen segment and its shadow rays;
    render_pass at 1024^2 against render_passes(n_pass=1); production
    sampling (production_tile) and a K = 64 tile of the gates and the
    textured scene (wide_tile); a procedural texture given as C source
    (source_phase); 64x64 card images of regen, production and render_pass
    against the CPU. Returns the "kernels" rows of the new path rows: B1/B2
    inside the regen loop and on a production tile's 2^20-ray wavefront."""
    from hydracore_tpu_torch.integrators import pt_regen as regen
    from hydracore_tpu_torch.ops import proctex
    from hydracore_tpu_torch.scene.procedural import bench_scene
    from hydracore_tpu_torch.scene.scene import assemble
    from hydracore_tpu_torch.utils.build import BUILD_DIR

    t0 = time.time()
    scene = bench_scene(WIDTH, HEIGHT, DEPTH).to(dev)
    flat = compare_schedules("phase 16 flat", pt, regen, tc, tp, scene, card,
                             {"closest_launches", "any_launches"}, N_PASS)
    regen_recs = check_kernels("phase 16 regen", tc, scene,
                               flat["regen"]["probe"].cases(tc, "regen"),
                               card)
    regen_counts = flat["regen"]["counts"]
    log(f"phase 16 flat schedules: {time.time() - t0:.2f} s")

    t0 = time.time()
    one, rays_one = pt.render_passes(scene, 5, SEED, n_pass=1,
                                     max_depth=DEPTH, device=dev)
    torch.cuda.synchronize()
    t1 = time.time()
    img, rays = pt.render_pass(scene, 5, SEED, max_depth=DEPTH, device=dev)
    torch.cuda.synchronize()
    close = pixels_close(img, one)
    log(f"phase 16 render_pass: {WIDTH}x{HEIGHT} in {time.time() - t1:.3f} s "
        f"({int(rays)} rays) against render_passes(n_pass=1) in "
        f"{t1 - t0:.3f} s ({int(rays_one)} rays); pixels within 1e-3: "
        f"{close:.6f} [{card}]")
    if close < 0.99 or abs(int(rays) - int(rays_one)) > 0.02 * int(rays_one):
        raise AssertionError(f"phase 16 render_pass: {close}, rays {int(rays)}"
                             f" / {int(rays_one)}")

    t0 = time.time()
    sky = sky_scene(WIDTH, HEIGHT).to(dev)
    compare_schedules("phase 16 sky", pt, regen, tc, tp, sky, card,
                      {"closest_launches", "any_launches"}, N_PASS)
    del sky
    log(f"phase 16 sky schedules: {time.time() - t0:.2f} s")

    t0 = time.time()
    lib = tempfile.mkdtemp(prefix="gates_", dir=BUILD_DIR)
    proctex.clear_registry()
    try:
        gscene = assemble(gates_desc(lib, WIDTH, HEIGHT)).to(dev)
        gates = compare_schedules(
            "phase 16 gates", pt, regen, tc, tp, gscene, card,
            {"closest_launches", "any_launches", "ao_any_launches"}, 1)
        wide_tile("phase 16 gates", pt, tc, tp, gscene, card,
                  {"closest_launches", "any_launches", "ao_any_launches"})
        del gscene
    finally:
        shutil.rmtree(lib, ignore_errors=True)
        proctex.clear_registry()
    log(f"phase 16 gates schedules and tile: {time.time() - t0:.2f} s")

    t0 = time.time()
    lib = tempfile.mkdtemp(prefix="textured_", dir=BUILD_DIR)
    try:
        tscene = assemble(textured_desc(lib, WIDTH, HEIGHT)).to(dev)
        wide_tile("phase 16 textured", pt, tc, tp, tscene, card,
                  {"closest_launches", "opaque_any_launches"})
        del tscene
    finally:
        shutil.rmtree(lib, ignore_errors=True)
    log(f"phase 16 textured tile: {time.time() - t0:.2f} s")

    t0 = time.time()
    tile_recs, tile_counts = production_tile(pt, tc, tp, scene, card)
    del scene
    log(f"phase 16 production: {time.time() - t0:.2f} s")

    t0 = time.time()
    source_phase(card, pt, tc, tp, dev, gates["pass loop"]["profile"])
    log(f"phase 16 proc-tex source: {time.time() - t0:.2f} s")

    t0 = time.time()
    small = bench_scene(64, 64, DEPTH)
    twin_image("phase 16 regen (4,096 lanes, 8 passes)", lambda dv:
               pt.render_passes(small, 0, SEED, n_pass=8, max_depth=DEPTH,
                                device=dv, regen=True, lanes=4096)[0] / 8)
    twin_image("phase 16 production (spp 8, tiles of 1,024)", lambda dv:
               pt.render_production(small, 8, seed=SEED, max_depth=DEPTH,
                                    tile_pixels=1024, device=dv))
    twin_image("phase 16 render_pass", lambda dv:
               pt.render_pass(small, 3, SEED, max_depth=DEPTH, device=dv)[0])
    log(f"phase 16 64x64 images: {time.time() - t0:.2f} s")

    at = "hydracore_tpu/ops/traverse_cluster.py:576"
    b12 = ("B1 cluster traversal", "B2 cluster traversal")
    return (kernel_rows(b12, "flat pool Cp 384, inside the regen loop",
                        CLUSTER_CU, at, regen_recs,
                        (regen_counts["closest_launches"],
                         regen_counts["any_launches"]))
            + kernel_rows(b12, "flat pool Cp 384, a production tile's 2^20-ray "
                          "wavefront", CLUSTER_CU, at, tile_recs, tile_counts))


# ---------------------------------------------------------------------------
# Phase 17: light tracing, the G-buffer and adaptive sampling
# ---------------------------------------------------------------------------

LT_PATHS = 1 << 20  # light paths a pass: one 2^20-ray wavefront a bounce


class TraceProbe:
    """Wraps closest-hit and any-hit functions as a module imported them
    (`targets`: (module, attribute, "closest" or "any")) to count the calls
    and the live rays of every call, summed on the device (no host read
    inside the run), and with `keep` to keep the rays of the first call of
    each kind as the kernel gets them."""

    def __init__(self, targets, keep: bool = True, keep_at=None):
        self.targets = targets
        self.keep = keep
        # {kind: {call index: name}}: keep those calls' rays instead, by name
        self.keep_at = keep_at
        self.live = {"closest": 0, "any": 0}
        self.calls = {"closest": 0, "any": 0}
        self.kept = {}

    def __enter__(self):
        self.saved = [getattr(m, a) for m, a, _ in self.targets]
        for (mod, attr, kind), fn in zip(self.targets, self.saved):
            setattr(mod, attr, self._wrap(fn, kind))
        return self

    def _wrap(self, fn, kind):
        def call(scene, ray_o, ray_d, t_max=1e30, active=None, *args, **kw):
            key = (kind if self.keep_at is None
                   else self.keep_at.get(kind, {}).get(self.calls[kind]))
            if self.keep and key is not None and key not in self.kept:
                tm = t_max.clone() if isinstance(t_max, torch.Tensor) else t_max
                self.kept[key] = (ray_o.clone(), ray_d.clone(), tm,
                                  None if active is None else active.clone())
            self.calls[kind] += 1
            self.live[kind] = self.live[kind] + (
                ray_o.shape[0] if active is None else active.sum())
            return fn(scene, ray_o, ray_d, t_max, active, *args, **kw)
        return call

    def __exit__(self, *exc):
        for (mod, attr, _), fn in zip(self.targets, self.saved):
            setattr(mod, attr, fn)

    def rays(self, kind) -> int:
        return int(self.live[kind])

    def raw(self, names):
        """The kept wavefronts as wavefronts() gives them:
        [(name, o, d, t_max, active, any_hit_mode)]."""
        return [(name, *self.kept[kind], kind == "any")
                for kind, name in zip(("closest", "any"), names)]

    def raw_at(self):
        """The calls kept by keep_at, in its order, as raw() gives them."""
        return [(name, *self.kept[name], kind == "any")
                for kind, at in self.keep_at.items() for name in at.values()]


def probed(targets, fn, runs: list):
    """fn wrapped so that each call runs under a counting TraceProbe (no
    rays kept), appended to `runs`."""
    def run():
        with TraceProbe(targets, keep=False) as probe:
            out = fn()
        runs.append(probe)
        return out
    return run


def lt_path(tag, pt, tc, tp, scene, card, prefix: str) -> tuple:
    """render_lt on `scene` at WIDTH x HEIGHT, LT_PATHS paths a pass, depth
    DEPTH, N_PASS passes: DEPTH - 1 closest-hit and DEPTH - 1 any-hit
    launches a pass through the counters named by `prefix` ("" or "pkt_"),
    Mpaths/s and Mrays/s (the live rays of the timed run, counted in it by
    a TraceProbe), peak memory, a profiled pass. Returns (the probe of an
    untimed pass, which keeps its first wavefront of each kind, the
    counts)."""
    from hydracore_tpu_torch.integrators import lt

    dev = scene.tri_attr.device
    n = DEPTH - 1
    targets = [(lt, "closest_hit", "closest"), (lt, "any_hit", "any")]
    runs = []
    img, dt, counts, peak = timed_call(
        tag, tc, tp, probed(targets, lambda: lt.render_lt(
            scene, N_PASS, LT_PATHS, SEED, DEPTH, device=dev), runs), card,
        {prefix + "closest_launches": n * N_PASS,
         prefix + "any_launches": n * N_PASS})
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(
            torch.isfinite(img).all()) or float(img.sum()) <= 0.0:
        raise AssertionError(f"{tag}: image not finite and non-zero")
    live = runs[-1]
    light, cam = live.rays("closest"), live.rays("any")
    paths = N_PASS * LT_PATHS
    log(f"{tag}: {WIDTH}x{HEIGHT} depth {DEPTH} {N_PASS} passes of "
        f"{LT_PATHS} paths in {dt:.3f} s: {paths / dt / 1e6:.4f} Mpaths/s, "
        f"{(light + cam) / dt / 1e6:.4f} Mrays/s ({light + cam} live rays "
        f"counted in the timed run: {light} light, {cam} camera "
        f"connections, in {live.calls['closest']} + {live.calls['any']} "
        f"wavefronts of {LT_PATHS}); launches {counts}; peak device memory "
        f"{peak / 2**20:.1f} MiB above the scene's [{card}]")
    with TraceProbe(targets) as probe:
        lt.render_lt(scene, 1, LT_PATHS, SEED, DEPTH, device=dev)
        torch.cuda.synchronize()
    profile_pass(pt, scene, card, tag, what=f"one pass of {LT_PATHS} paths",
                 run=lambda: lt.render_lt(scene, 1, LT_PATHS, SEED, DEPTH,
                                          device=dev))
    return probe, counts


def gbuffer_path(tag, pt, tc, tp, scene, card, prefix: str) -> tuple:
    """eval_gbuffer on `scene` at WIDTH x HEIGHT with 4 subsamples (each a
    2^20-ray wavefront of eye rays and one of shadow rays, the latter put
    into coherence order as the JAX package does): 4 + 4 launches through
    the counters named by `prefix` ("" or "inst_"), the layers' time, the
    live shadow rays of the timed run, a profile. Returns (the layers, the
    probe of an untimed call, which keeps the first eye wavefront and the
    first shadow wavefront as B2/B3 get it, the counts)."""
    from hydracore_tpu_torch.integrators import gbuffer
    from hydracore_tpu_torch.ops import trace_api

    dev = scene.tri_attr.device
    targets = [(gbuffer, "closest_hit", "closest"),
               (trace_api, "any_hit", "any")]
    runs = []
    g, dt, counts, peak = timed_call(
        tag, tc, tp, probed(targets, lambda: gbuffer.eval_gbuffer(
            scene, SEED, 4, device=dev), runs), card,
        {prefix + "closest_launches": 4, prefix + "any_launches": 4})
    for k, v in g.items():
        if tuple(v.shape[:2]) != (HEIGHT, WIDTH):
            raise AssertionError(f"{tag}: layer {k} shape {tuple(v.shape)}")
    cover = float(g["coverage"].mean())
    if not (cover > 0.5 and bool(torch.isfinite(g["depth"]).all())
            and 0.0 < float(g["shadow"].mean()) <= 1.0):
        raise AssertionError(f"{tag}: layers out of range")
    if runs[-1].calls["any"] != 4:
        raise AssertionError(f"{tag}: the shadow rays did not go through "
                             f"any_hit_sorted ({runs[-1].calls})")
    with TraceProbe(targets) as probe:
        gbuffer.eval_gbuffer(scene, SEED, 4, device=dev)
        torch.cuda.synchronize()
    log(f"{tag}: {WIDTH}x{HEIGHT}, 4 subsamples, every layer in "
        f"{dt * 1e3:.2f} ms ({4 * WIDTH * HEIGHT / dt / 1e6:.4f} Meye-rays/s; "
        f"{runs[-1].rays('any')} live shadow rays, sorted); coverage "
        f"{cover:.4f}, shadow {float(g['shadow'].mean()):.4f}, ids "
        f"{int(g['mat_id'].max()) + 1} materials, {int(g['inst_id'].max()) + 1}"
        f" instances; launches {counts}; peak device memory "
        f"{peak / 2**20:.1f} MiB above the scene's [{card}]")
    profile_pass(pt, scene, card, tag, what="the G-buffer, 4 subsamples",
                 run=lambda: gbuffer.eval_gbuffer(scene, SEED, 4, device=dev))
    return g, probe, counts


ADAPT_NOISE = 0.15  # render_adaptive's default noise threshold


def adaptive_path(tag, tc, tp, scene, card, spp_base, spp_max, tile) -> int:
    """render_adaptive on `scene`, timed with its launch counters: the noisy
    pixels (read from the noise map it computes, kept by wrapping
    gbuffer.noise_map), the rounds and the rays a tile's wavefront. Returns
    the noisy pixels."""
    from hydracore_tpu_torch.integrators import gbuffer

    dev = scene.tri_attr.device
    W, H = scene.camera.width, scene.camera.height
    maps = []
    noise_map = gbuffer.noise_map

    def run():
        maps.clear()
        gbuffer.noise_map = lambda *a: maps.append(noise_map(*a)) or maps[-1]
        try:
            return gbuffer.render_adaptive(
                scene, spp_base, spp_max, SEED, DEPTH, ADAPT_NOISE,
                tile_pixels=tile, device=dev)
        finally:
            gbuffer.noise_map = noise_map

    img, dt, counts, _ = timed_call(
        tag, tc, tp, run, card,
        {"closest_launches": None, "any_launches": None})
    if img.shape != (H, W, 3) or not np.isfinite(img).all() or img.sum() <= 0:
        raise AssertionError(f"{tag}: image not finite and non-zero")
    k = min(max(spp_base, 1), 32)
    rounds = -(-spp_base // k)
    extra = max(-(-(spp_max - spp_base) // k), 0)
    noisy = int((maps[0] > ADAPT_NOISE).sum())
    samples = W * H * rounds * k + noisy * extra * k
    log(f"{tag}: {W}x{H} spp {spp_base} -> {spp_max}, tiles of {tile} pixels "
        f"x K = {k} ({tile * k} rays a wavefront), {rounds} base rounds, "
        f"{noisy} noisy pixels topped up by {extra} rounds, in {dt:.3f} s "
        f"({samples / dt / 1e6:.4f} Msamples/s); launches {counts} [{card}]")
    return noisy


def sorted_light_rays(tag, tc, scene, probe, card) -> None:
    """An open question, off the path (the JAX package traces LT's light
    rays as they come): B1 on LT's first light wavefront in coherence order
    (trace_api.coherence_order) against the same rays unsorted, and the
    sort's own time."""
    from hydracore_tpu_torch.ops.trace_api import coherence_order

    _, o, d, t_max, act, _ = probe.raw(("light", "camera"))[0]
    sort_ms = lab.time_ms(lambda: coherence_order(scene, o, d, act), 5,
                          o.device)
    idx = coherence_order(scene, o, d, act)
    pool = tc.scene_pool(scene)
    cases = cluster_cases(tc, [("light", o, d, t_max, act, False),
                               ("sorted", o[idx], d[idx], t_max, act[idx],
                                False)])
    (tu, su), (ts, ss) = [tc.cluster_traverse(b, any_hit_mode=False, **pool)
                          for _, b, _ in cases]
    if int((su >= 0).sum()) != int((ss >= 0).sum()):
        raise AssertionError(f"{tag}: sorting changed the hits")
    ms = [lab.time_ms(lambda b=b: tc.cluster_traverse(
        b, any_hit_mode=False, **pool), 20, o.device) for _, b, _ in cases]
    log(f"{tag} light, off the path: B1 on the rays as they come "
        f"{ms[0]:.4f} ms, in coherence order {ms[1]:.4f} ms, the sort "
        f"{sort_ms:.4f} ms [{card}]")


def gbuffer_twins(tag, small) -> None:
    """Every G-buffer layer on the card against the CPU twins: float layers
    by the image rule (+inf on the same pixels), ids equal on >= 99%."""
    from hydracore_tpu_torch.integrators import gbuffer

    g_card = gbuffer.eval_gbuffer(small, SEED, 4, device="cuda")
    t0 = time.time()
    g_cpu = gbuffer.eval_gbuffer(small, SEED, 4, device="cpu")
    shares = {}
    for k, v in g_cpu.items():
        a = g_card[k].cpu()
        if k in ("mat_id", "inst_id"):
            shares[k] = float((a == v).float().mean())
            ok = shares[k] >= 0.99
        else:
            a, b = (a[..., None], v[..., None]) if v.dim() == 2 else (a, v)
            inf = torch.isinf(a) & torch.isinf(b)
            d = torch.where(inf, 0.0, a - b).abs().amax(dim=-1)
            shares[k] = float((d <= 1e-3).float().mean())
            ok = shares[k] >= 0.99
        if not ok:
            raise AssertionError(f"{tag} G-buffer {k}: card vs CPU {shares[k]}")
    log(f"{tag} G-buffer 64x64: pixels within 1e-3 (ids: equal) of the CPU's "
        f"layers: " + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
        + f" (the CPU's layers {time.time() - t0:.2f} s)")


def lt_gbuffer_phase(card, pt, tc, tp, dev, host_inst, inst_desc,
                     host_pkt) -> list:
    """Phase 17: light tracing, the G-buffer and adaptive sampling at
    WIDTH x HEIGHT, depth DEPTH, seed SEED. LT on the flat scene (B1 on its
    unsorted light wavefronts, B2 on its camera connections, both against
    their twins on the first of each) and on the packet scene of phase 8 (B4
    in both modes against its twin on the first whole wavefront of each, no
    packet at MAX_VISITS); the G-buffer on the flat scene (B1, B2) and on the
    instanced scene of phase 6 (B3 in both modes), whose inst_id must equal
    the flattened assembly's on >= 99.9% of pixels; render_adaptive on the
    flat scene at spp 8 -> 16 in tiles of 131,072 pixels (2^20 rays a
    wavefront) and of 16,384 (the default), and at 256^2, spp 33 -> 40,
    where two base rounds can mark pixels noisy; off the path, B1 on LT's
    light wavefront sorted (sorted_light_rays); 64x64 card against CPU for
    LT, every G-buffer layer and render_adaptive. Returns the "kernels" rows
    of the new paths."""
    from hydracore_tpu_torch.integrators import gbuffer, lt
    from hydracore_tpu_torch.scene.procedural import bench_scene
    from hydracore_tpu_torch.scene.scene import assemble

    t0 = time.time()
    scene = bench_scene(WIDTH, HEIGHT, DEPTH).to(dev)
    probe, lt_counts = lt_path("phase 17 LT flat", pt, tc, tp, scene, card, "")
    lt_recs = check_kernels("phase 17 LT flat", tc, scene, cluster_cases(
        tc, probe.raw(("light", "camera"))), card)
    sorted_light_rays("phase 17 LT flat", tc, scene, probe, card)
    del probe
    log(f"phase 17 LT flat: {time.time() - t0:.2f} s")

    t0 = time.time()
    g, probe, gb_counts = gbuffer_path("phase 17 G-buffer flat", pt, tc, tp,
                                       scene, card, "")
    gb_recs = check_kernels("phase 17 G-buffer flat", tc, scene, cluster_cases(
        tc, probe.raw(("eye", "shadow"))), card)
    del probe, g
    adaptive_path("phase 17 adaptive flat", tc, tp, scene, card, 8, 16, 131072)
    # the default tile width (131,072 rays a wavefront at K = 8), for the
    # open question of adaptive's tile width
    adaptive_path("phase 17 adaptive flat, default tiles", tc, tp, scene, card,
                  8, 16, 16384)
    small = bench_scene(256, 256, DEPTH).to(dev)
    noisy = adaptive_path("phase 17 adaptive flat 256^2", tc, tp, small, card,
                          33, 40, 32768)
    if noisy <= 0:
        raise AssertionError("phase 17 adaptive 256^2: no pixel topped up")
    del scene, small
    log(f"phase 17 G-buffer and adaptive flat: {time.time() - t0:.2f} s")

    t0 = time.time()
    inst_scene = host_inst.to(dev)
    gi, probe, inst_counts = gbuffer_path("phase 17 G-buffer instanced", pt,
                                          tc, tp, inst_scene, card, "inst_")
    inst_recs = check_kernels("phase 17 G-buffer instanced", tc, inst_scene,
                              cluster_cases(tc, probe.raw(("eye", "shadow"))),
                              card)
    del probe, inst_scene
    t1 = time.time()
    flat = assemble(inst_desc, instancing="off").to(dev)
    gf = gbuffer.eval_gbuffer(flat, SEED, 4, device=dev)
    same = float((gi["inst_id"] == gf["inst_id"]).float().mean())
    log(f"phase 17 G-buffer instanced: inst_id equal to the flattened "
        f"assembly's ({flat.num_triangles} triangles, assembled and its "
        f"G-buffer in {time.time() - t1:.2f} s) on {same:.6f} of pixels, "
        f"{len(torch.unique(gi['inst_id']))} ids")
    if same < 0.999:
        raise AssertionError(f"phase 17 instanced inst_id: {same}")
    del flat, gi, gf
    log(f"phase 17 G-buffer instanced: {time.time() - t0:.2f} s")

    t0 = time.time()
    pkt_scene = host_pkt.to(dev)
    probe, pkt_counts = lt_path("phase 17 LT packet", pt, tc, tp, pkt_scene,
                                card, "pkt_")
    packet_peak("phase 17 LT packet", tp, lambda: lt.render_lt(
        pkt_scene, N_PASS, LT_PATHS, SEED, DEPTH, device=dev))
    pkt_recs = check_packet("phase 17 LT packet", tp, pkt_scene,
                            probe.raw(("light", "camera")), card)
    del probe, pkt_scene
    log(f"phase 17 LT packet: {time.time() - t0:.2f} s")

    t0 = time.time()
    small = bench_scene(64, 64, DEPTH)
    twin_image("phase 17 LT (2 passes of 16,384 paths)", lambda dv:
               lt.render_lt(small, 2, 16384, SEED, DEPTH, device=dv))
    gbuffer_twins("phase 17", small)
    twin_image("phase 17 adaptive (spp 8 -> 16, tiles of 1,024)", lambda dv:
               torch.as_tensor(gbuffer.render_adaptive(
                   small, 8, 16, SEED, DEPTH, tile_pixels=1024, device=dv)))
    log(f"phase 17 64x64 images: {time.time() - t0:.2f} s")

    at = "hydracore_tpu/ops/traverse_cluster.py"
    b12 = ("B1 cluster traversal", "B2 cluster traversal")
    b3 = ("B3 cluster traversal", "B3 cluster traversal")
    b4 = ("B4 packet traversal", "B4 packet traversal")
    return (kernel_rows(b12, "flat pool Cp 384, LT's unsorted 2^20-ray "
                        "wavefronts", CLUSTER_CU, f"{at}:576", lt_recs,
                        (lt_counts["closest_launches"],
                         lt_counts["any_launches"]))
            + kernel_rows(b12, "flat pool Cp 384, G-buffer 2^20-ray "
                          "wavefronts", CLUSTER_CU, f"{at}:576", gb_recs,
                          (gb_counts["closest_launches"],
                           gb_counts["any_launches"]))
            + kernel_rows(b3, f"instanced Ci {host_inst.cl_map.shape[1]}, "
                          "G-buffer 2^20-ray wavefronts", CLUSTER_CU,
                          f"{at}:394", inst_recs,
                          (inst_counts["inst_closest_launches"],
                           inst_counts["inst_any_launches"]))
            + kernel_rows(b4, f"{host_pkt.wbvh_nodes.shape[0]} wide nodes, "
                          "LT's unsorted 2^20-ray wavefronts", PACKET_CU,
                          "hydracore_tpu/ops/traverse_packet.py:204", pkt_recs,
                          (pkt_counts["pkt_closest_launches"],
                           pkt_counts["pkt_any_launches"])))

# ---------------------------------------------------------------------------
# Phase 18: bidirectional path tracing (SBDPT and IBPT)
# ---------------------------------------------------------------------------

# the statistical checks of the bidirectional tests, at their own counts
BD_W = 16
BD_ORACLE_PASSES = 192
BD_RECT = [(0, 2), (1, 2), (1, 3), (2, 1), (2, 2)]
BD_SKY = [(0, 2), (0, 3), (1, 2), (1, 3), (2, 1), (2, 2)]


def bd_launches(depth: int, strategies: str) -> tuple[int, int]:
    """Closest-hit and any-hit wavefronts of one SBDPT pass at `depth`:
    depth camera and depth - 1 light wavefronts; NEE from depth - 1 camera
    vertices, depth - 1 light vertices to the camera, and (full only) the
    inner connections of at most depth segments."""
    inner = sum(1 for t in range(2, depth + 1) for s in range(2, depth + 1)
                if s + t - 1 <= depth)
    return (2 * depth - 1,
            2 * (depth - 1) + (inner if strategies == "full" else 0))


def bd_keep(depth: int, strategies: str) -> dict:
    """TraceProbe.keep_at for BDPT's first wavefront of each kind: the
    unsorted camera wavefront, the first sorted light wavefront, the first
    NEE, t = 1 and inner-connection wavefronts."""
    keep = {"closest": {0: "camera", depth: "light"},
            "any": {0: "NEE", depth - 1: "t=1"}}
    if strategies == "full":
        keep["any"][2 * depth - 2] = "inner"
    return keep


def bd_targets():
    """BDPT's first camera trace (integrators/bdpt.py's closest_hit) and
    every other trace where ops/trace_api.py calls its traversal, so a
    sorted call is seen in the order the kernel gets it."""
    from hydracore_tpu_torch.integrators import bdpt
    from hydracore_tpu_torch.ops import trace_api

    return [(bdpt, "closest_hit", "closest"),
            (trace_api, "closest_hit", "closest"),
            (trace_api, "any_hit", "any")]


def bdpt_path(tag, pt, tc, tp, scene, card, prefix: str, strategies: str,
              n_pass: int, keep: bool) -> tuple:
    """render_bdpt on `scene` at its size, depth DEPTH, `n_pass` passes of
    one sample a pixel (2^20 lanes a pass at 1024^2): the launches of each
    kernel a pass (bd_launches, through the counters named by `prefix`),
    Msamples/s, Mrays/s (live rays of the timed run), peak memory, a
    profiled pass. Returns (the probe of an untimed pass that kept BDPT's
    first wavefront of each kind when `keep`, the counts, the profile)."""
    from hydracore_tpu_torch.integrators import bdpt

    dev = scene.tri_attr.device
    W, H = scene.camera.width, scene.camera.height
    n_c, n_a = bd_launches(DEPTH, strategies)

    def render(n=n_pass):
        return bdpt.render_bdpt(scene, n, SEED, DEPTH, strategies, device=dev)

    runs = []
    img, dt, counts, peak = timed_call(
        tag, tc, tp, probed(bd_targets(), render, runs), card,
        {prefix + "closest_launches": n_c * n_pass,
         prefix + "any_launches": n_a * n_pass}, warm=lambda: render(1))
    if tuple(img.shape) != (H, W, 3) or not bool(
            torch.isfinite(img).all()) or float(img.sum()) <= 0.0:
        raise AssertionError(f"{tag}: image not finite and non-zero")
    live = runs[-1]
    closest, any_ = live.rays("closest"), live.rays("any")
    log(f"{tag}: {W}x{H} depth {DEPTH} {strategies} {n_pass} passes in "
        f"{dt:.3f} s: {n_pass * W * H / dt / 1e6:.4f} Msamples/s, "
        f"{(closest + any_) / dt / 1e6:.4f} Mrays/s ({closest + any_} live "
        f"rays counted in the timed run: {closest} closest hit in "
        f"{live.calls['closest']} wavefronts, {any_} any hit in "
        f"{live.calls['any']}); launches a pass {n_c} + {n_a}: {counts}; peak "
        f"device memory {peak / 2**20:.1f} MiB above the scene's [{card}]")
    probe = None
    if keep:
        with TraceProbe(bd_targets(), keep_at=bd_keep(DEPTH,
                                                      strategies)) as probe:
            render(1)
            torch.cuda.synchronize()
    prof = profile_pass(pt, scene, card, tag, what=f"one {strategies} pass",
                        run=lambda: render(1))
    return probe, counts, prof


def bd_strategy_twins(tag, scene, strategies: str) -> None:
    """strategy_images of one pass on the card against the CPU twins: the
    same labels, each strategy's image by the image rule."""
    from hydracore_tpu_torch.integrators import bdpt

    card_imgs = bdpt.strategy_images(scene, 0, SEED, DEPTH, strategies,
                                     device="cuda")
    t0 = time.time()
    cpu_imgs = bdpt.strategy_images(scene, 0, SEED, DEPTH, strategies,
                                    device="cpu")
    if sorted(card_imgs) != sorted(cpu_imgs):
        raise AssertionError(f"{tag}: labels {sorted(card_imgs)} / "
                             f"{sorted(cpu_imgs)}")
    shares = {lbl: pixels_close(card_imgs[lbl].cpu(), img)
              for lbl, img in cpu_imgs.items()}
    log(f"{tag} {strategies}: per-strategy pixels within 1e-3 of the CPU's: "
        + ", ".join(f"{lbl} {v:.4f}" for lbl, v in sorted(shares.items()))
        + f" (the CPU's images {time.time() - t0:.2f} s)")
    if min(shares.values()) < 0.99:
        raise AssertionError(f"{tag} {strategies}: card vs CPU {shares}")


def bd_cornell(mirror: bool = False, width: int = BD_W):
    """tests/test_bdpt.py's cornell box (tests/test_oracle_bdpt.py's without
    the mirror; tests/test_mmlt.py's diffuse box, tests/test_oracle_mmlt.py's
    at 12^2) at width^2, depth 3."""
    from hydracore_tpu_torch.scene.procedural import SceneBuilder

    b = SceneBuilder()
    m = b.lambert([0.6, 0.6, 0.6])
    red = b.lambert([0.7, 0.15, 0.1])
    left = b.add_material(refl_color=np.array([0.85, 0.85, 0.85], np.float32)) \
        if mirror else red
    b.add_box_interior(2.0, m, m, m, left, m)
    b.rect_light([0, 1.95, 0], 0.6, 0.6, [10.0, 10.0, 10.0])
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=width,
                   height=width, trace_depth=3)


def bd_courtyard(env: str):
    """tests/test_bdpt_sky.py's courtyard (a floor and a red back wall under
    a sky) with a constant sky ("const"), its horizon-band image
    ("textured") or tests/test_oracle_bdpt_sky.py's image ("oracle")."""
    from hydracore_tpu_torch.scene.procedural import SceneBuilder

    img = None
    if env == "textured":
        img = np.full((16, 32, 4), 0.05, np.float32)
        img[6:9, :, :3] = 4.0
        img[:, :, 3] = 1.0
    elif env == "oracle":
        img = np.full((8, 16, 4), 0.15, np.float32)
        img[3:5, :, :3] = 3.0
        img[:, :, 3] = 1.0
    b = SceneBuilder()
    g = b.lambert([0.5, 0.5, 0.5])
    r = b.lambert([0.7, 0.2, 0.15])
    b.add_rect([0, -1, 0], [2.5, 0, 0], [0, 0, 2.5], g, flip=True)
    b.add_rect([0, 0.2, -1.8], [2.0, 0, 0], [0, 1.2, 0], r)
    b.sky([1.0, 1.0, 1.0], img=img)
    return b.build(cam_pos=[0, 0.7, 5.0], cam_lookat=[0, 0, 0], width=BD_W,
                   height=BD_W, trace_depth=3)


def bd_oracle_strategy(mode: str, s: int, t: int) -> np.ndarray:
    """OracleSBDPT.render_strategy(s, t, spp=48, seed=23) on the oracle
    tests' rect-light box or sky courtyard, on the CPU (a worker process of
    bidir_statistics)."""
    from hydracore_tpu_torch.integrators.oracle import OracleSBDPT

    torch.set_num_threads(1)
    sc = bd_cornell() if mode == "rect" else bd_courtyard("oracle")
    return OracleSBDPT(sc).render_strategy(s, t, spp=48, seed=23)


def bd_blocks(a, n: int = 4):
    w = a.shape[0] // n
    return a.reshape(n, w, n, w, 3).mean(axis=(1, 3))


def bd_against_oracle(tag, ref, got) -> str:
    """tests/test_oracle_bdpt.py's criteria: over the 4x4 blocks holding
    > 2% of the mean, mean within 15% and median block error < 25%; a
    strategy with no such block carries ~no energy on both sides."""
    rb, gb = bd_blocks(ref), bd_blocks(got)
    mask = rb.mean(-1) > 0.02 * max(ref.mean(), 1e-9)
    if not mask.any():
        if not got.mean() < max(1e-4, 4.0 * ref.mean()):
            raise AssertionError(f"{tag}: {got.mean()} against ~0")
        return f"~0 ({ref.mean():.2e} / {got.mean():.2e})"
    rel = np.abs(rb - gb).mean(-1)[mask] / np.maximum(rb.mean(-1)[mask], 1e-9)
    med = float(np.median(rel))
    tot = abs(got.mean() - ref.mean()) / max(ref.mean(), 1e-12)
    if tot >= 0.15 or med >= 0.25:
        raise AssertionError(f"{tag}: means {ref.mean()} / {got.mean()}, "
                             f"median block err {med}")
    return f"mean {tot:.2%} off, median block {med:.3f}"


def bd_against_pt(tag, ref, got, tol_mean, tol_block, floor,
                  n: int = 4) -> str:
    """tests/test_bdpt.py's, test_bdpt_sky.py's and test_mmlt.py's criteria
    (and, with n = 3, test_oracle_mmlt.py's): means within tol_mean, the
    median n x n-block error over blocks above `floor` below tol_block."""
    rel = abs(got.mean() - ref.mean()) / max(ref.mean(), 1e-9)
    rb, gb = bd_blocks(ref, n), bd_blocks(got, n)
    mask = rb.mean(-1) > floor
    med = float(np.median(np.abs(rb - gb).mean(-1)[mask]
                          / np.maximum(rb.mean(-1)[mask], 1e-9)))
    if rel >= tol_mean or med >= tol_block:
        raise AssertionError(f"{tag}: pt {ref.mean()} got {got.mean()}, "
                             f"median block err {med}")
    return f"mean {rel:.2%} off, median block {med:.3f}"


def bidir_statistics(card, pt, dev, meanwhile=None) -> None:
    """The statistical checks of the bidirectional tests at BD_W^2, their
    own pass counts and seeds, on `dev`: the port's BDPT per (s, t), 192
    passes of one wavefront, against the port's OracleSBDPT at 48 samples
    a pixel (tests/test_oracle_bdpt.py, test_oracle_bdpt_sky.py; the eleven
    oracle images in worker processes while the card renders and
    `meanwhile()` runs), and render_bdpt / render_ibpt at 64 passes against
    PT at 128 / 96 spp (tests/test_bdpt.py, test_bdpt_sky.py)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from hydracore_tpu_torch.integrators import bdpt

    t0 = time.time()
    jobs = [("rect", s, t) for s, t in BD_RECT] + [("sky", s, t)
                                                  for s, t in BD_SKY]
    workers = max(1, min(len(jobs), (os.cpu_count() or 2) - 1))
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = {job: ex.submit(bd_oracle_strategy, *job) for job in jobs}
        dev_imgs = {}
        for mode, sc in (("rect", bd_cornell()),
                         ("sky", bd_courtyard("oracle"))):
            t1 = time.time()
            imgs = bdpt.strategy_images(sc, range(BD_ORACLE_PASSES), 5, 3,
                                        device=dev)
            dev_imgs[mode] = {k: v.double().cpu().numpy()
                              for k, v in imgs.items()}
            log(f"phase 18 statistics {mode}: {BD_ORACLE_PASSES} passes of "
                f"{BD_W}^2 in one wavefront on {dev} in "
                f"{time.time() - t1:.2f} s [{card}]")

        def pt_image(sc, spp):
            img, _ = pt.render_passes(sc, 0, 3, n_pass=spp, max_depth=3,
                                      device=dev)
            return (img / spp).cpu().numpy()

        t1 = time.time()
        checks = []
        box = bd_cornell()
        ref = pt_image(box, 128)
        for name, strat, seed in (("SBDPT", "full", 5), ("IBPT", "3way", 9)):
            got = bdpt.render_bdpt(box, 64, seed, strategies=strat,
                                   device=dev).cpu().numpy()
            checks.append((f"{name} diffuse box", bd_against_pt(
                f"phase 18 {name} diffuse", ref, got, 0.08, 0.1, 0.05)))
        mirror = bd_cornell(mirror=True)
        got = bdpt.render_bdpt(mirror, 64, 5, device=dev).cpu().numpy()
        checks.append(("SBDPT mirror box", bd_against_pt(
            "phase 18 SBDPT mirror", pt_image(mirror, 128), got, 0.12, 0.15,
            0.05)))
        for env in ("const", "textured"):
            sc = bd_courtyard(env)
            ref = pt_image(sc, 96)
            runs = [("SBDPT", "full")] + ([("IBPT", "3way")]
                                          if env == "const" else [])
            for name, strat in runs:
                got = bdpt.render_bdpt(sc, 64, 9, strategies=strat,
                                       device=dev).cpu().numpy()
                checks.append((f"{name} sky {env}", bd_against_pt(
                    f"phase 18 {name} sky {env}", ref, got, 0.10, 0.15,
                    0.05 * ref.mean())))
        log(f"phase 18 statistics against PT ({time.time() - t1:.2f} s): "
            + "; ".join(f"{k}: {v}" for k, v in checks))
        if meanwhile is not None:
            meanwhile()
        t1 = time.time()
        res = {}
        for (mode, s, t), fut in futures.items():
            ref = fut.result()
            res[mode, s, t] = bd_against_oracle(
                f"phase 18 oracle {mode} ({s}, {t})", ref,
                dev_imgs[mode][(s, t)])
    log(f"phase 18 statistics against OracleSBDPT (waited "
        f"{time.time() - t1:.2f} s for {workers} workers): "
        + "; ".join(f"{m} ({s},{t}) {v}" for (m, s, t), v in res.items()))
    log(f"phase 18 statistics: {time.time() - t0:.2f} s")


def bidir_phase(card, pt, tc, tp, dev, host_inst, host_pkt) -> list:
    """Phase 18: SBDPT and IBPT at WIDTH x HEIGHT, depth DEPTH, seed SEED,
    2^20 lanes a pass. render_bdpt (full) and render_ibpt on the flat scene
    (B1, B2; N_PASS passes each), render_bdpt on sky_scene (the env
    strategies, one pass), on the packet scene of phase 8 (B4, one pass; no
    packet at MAX_VISITS) and render_ibpt on the instanced scene of phase 6
    (B3, one pass): each timed with its launch counters (bd_launches a
    pass), its live rays and peak memory, and profiled; B1/B2, B4 and B3
    against their twins on BDPT's first camera (unsorted), light, NEE,
    t = 1 and inner-connection wavefronts (bd_keep); the statistical
    checks of bidir_statistics and, while its oracle works, the
    per-strategy images of full and 3-way at 64^2 card against CPU (flat;
    full on the sky scene). Returns the "kernels" rows of the new paths."""
    from hydracore_tpu_torch.integrators import bdpt
    from hydracore_tpu_torch.scene.procedural import bench_scene

    t0 = time.time()
    scene = bench_scene(WIDTH, HEIGHT, DEPTH).to(dev)
    probe, full_counts, _ = bdpt_path("phase 18 SBDPT flat", pt, tc, tp,
                                      scene, card, "", "full", N_PASS, True)
    full_recs = check_kernels("phase 18 SBDPT flat", tc, scene,
                              cluster_cases(tc, probe.raw_at()), card)
    del probe
    bdpt_path("phase 18 IBPT flat", pt, tc, tp, scene, card, "", "3way",
              N_PASS, False)
    del scene
    log(f"phase 18 flat: {time.time() - t0:.2f} s")

    t0 = time.time()
    sky = sky_scene(WIDTH, HEIGHT).to(dev)
    bdpt_path("phase 18 SBDPT sky", pt, tc, tp, sky, card, "", "full", 1,
              False)
    del sky
    log(f"phase 18 sky: {time.time() - t0:.2f} s")

    t0 = time.time()
    pkt_scene = host_pkt.to(dev)
    probe, pkt_counts, _ = bdpt_path("phase 18 SBDPT packet", pt, tc, tp,
                                     pkt_scene, card, "pkt_", "full", 1, True)
    packet_peak("phase 18 SBDPT packet", tp, lambda: bdpt.render_bdpt(
        pkt_scene, 1, SEED, DEPTH, device=dev))
    pkt_recs = check_packet("phase 18 SBDPT packet", tp, pkt_scene,
                            probe.raw_at(), card)
    del probe, pkt_scene
    log(f"phase 18 packet: {time.time() - t0:.2f} s")

    t0 = time.time()
    inst_scene = host_inst.to(dev)
    probe, inst_counts, _ = bdpt_path("phase 18 IBPT instanced", pt, tc, tp,
                                      inst_scene, card, "inst_", "3way", 1,
                                      True)
    inst_recs = check_kernels("phase 18 IBPT instanced", tc, inst_scene,
                              cluster_cases(tc, probe.raw_at()), card)
    del probe, inst_scene
    log(f"phase 18 instanced: {time.time() - t0:.2f} s")

    def twins():
        t0 = time.time()
        small = bench_scene(64, 64, DEPTH)
        for strat in ("full", "3way"):
            bd_strategy_twins("phase 18 flat 64x64", small, strat)
        bd_strategy_twins("phase 18 sky 64x64", sky_scene(64, 64), "full")
        log(f"phase 18 64x64 images: {time.time() - t0:.2f} s")

    bidir_statistics(card, pt, dev, meanwhile=twins)

    at = "hydracore_tpu/ops/traverse_cluster.py"
    b12 = ("B1 cluster traversal", "B2 cluster traversal")
    b3 = ("B3 cluster traversal", "B3 cluster traversal")
    b4 = ("B4 packet traversal", "B4 packet traversal")
    return (kernel_rows(b12, "flat pool Cp 384, SBDPT's 2^20-ray wavefronts",
                        CLUSTER_CU, f"{at}:576", full_recs,
                        (full_counts["closest_launches"],
                         full_counts["any_launches"]))
            + kernel_rows(b3, f"instanced Ci {host_inst.cl_map.shape[1]}, "
                          "IBPT's 2^20-ray wavefronts", CLUSTER_CU,
                          f"{at}:394", inst_recs,
                          (inst_counts["inst_closest_launches"],
                           inst_counts["inst_any_launches"]))
            + kernel_rows(b4, f"{host_pkt.wbvh_nodes.shape[0]} wide nodes, "
                          "SBDPT's unsorted 2^20-ray wavefronts", PACKET_CU,
                          "hydracore_tpu/ops/traverse_packet.py:204",
                          pkt_recs, (pkt_counts["pkt_closest_launches"],
                                     pkt_counts["pkt_any_launches"])))


# ---------------------------------------------------------------------------
# Phase 19: Metropolis light transport (PSSMLT and MMLT)
# ---------------------------------------------------------------------------

MLT_CHAINS = 1 << 20  # chains of every 1024^2 run: one wavefront a mutation
MLT_MUT = 4  # mutations a pass
MLT_TWIN_W = 64  # the card-against-CPU steps


def mlt_targets():
    """PSSMLT's traces: the first (chain-order) camera wavefront where
    integrators/pt.py calls closest_hit, every other one where
    ops/trace_api.py calls its traversal, so the sorted bounces and shadow
    rays are seen as the kernel gets them."""
    from hydracore_tpu_torch.integrators import pt as ptm
    from hydracore_tpu_torch.ops import trace_api

    return [(ptm, "closest_hit", "closest"),
            (trace_api, "closest_hit", "closest"),
            (trace_api, "any_hit", "any")]


def host_syncs(run) -> int:
    """The synchronizing CUDA operations of run(), as the sync debug mode
    reports them."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in seen)


def metropolis_run(tag, pt, tc, tp, scene, card, prefix: str, method: str,
                   n_pass: int) -> tuple:
    """render_mlt or render_mmlt ("mlt", "mmlt") on `scene` at its size,
    MLT_CHAINS chains, depth DEPTH, `n_pass` passes of MLT_MUT mutations
    (MLT: the first pass a burn-in one when there are two; MMLT: the
    default 16 probe rounds): the exact launches of each kernel through the
    counters named by `prefix`, Mmutations/s over the mutation loop,
    Mrays/s (the live rays of the timed run), the acceptance rate, b or b_k
    and the allocation, the start's or burn-in's seconds, peak memory, and
    one mutation profiled, with its host syncs. The timed run also keeps
    the first mutation's camera wavefront (chain order) and its first
    bounce and shadow wavefronts (MLT; sorted inside the call on the
    cluster route) or its first connection wavefront (MMLT), as the kernel
    gets them. Returns (that probe, the counts, the profile)."""
    from hydracore_tpu_torch.integrators import mlt, mmlt

    dev = scene.tri_attr.device
    W, H = scene.camera.width, scene.camera.height
    steps = n_pass * MLT_MUT
    if method == "mlt":
        targets = mlt_targets()
        n_c, n_a = DEPTH, DEPTH - 1  # a trace of the chains' vectors
        evals = steps + 1  # the start's trace, then one a mutation

        def render(n=n_pass, m=MLT_MUT, stats=None):
            return mlt.render_mlt(scene, n, MLT_CHAINS, m, SEED, DEPTH,
                                  burn_in=1 if n > 1 else 0, device=dev,
                                  stats=stats)
        keep_at = {"closest": {n_c: "camera", n_c + 1: "first bounce"},
                   "any": {n_a: "first shadow"}}

        def warm():
            return render(1, 1)
    else:
        targets = bd_targets()
        n_c, n_a = bd_launches(DEPTH, "full")
        rounds = max(1, min(int(scene.settings.mmlt_burn_iters), 16))
        evals = rounds + 1 + steps  # probe rounds, the starts, mutations

        def render(n=n_pass, m=MLT_MUT, stats=None, cap=16):
            return mmlt.render_mmlt(scene, n, MLT_CHAINS, m, SEED, DEPTH,
                                    burn_rounds_cap=cap, device=dev,
                                    stats=stats)
        keep_at = {"closest": {(rounds + 1) * n_c: "camera"},
                   "any": {(rounds + 1) * n_a: "connection"}}

        def warm():
            return render(1, 1, cap=1)

    runs, st = [], {}

    def timed():
        with TraceProbe(targets, keep_at=keep_at) as probe:
            out = render(stats=st)
        runs.append(probe)
        return out

    img, dt, counts, peak = timed_call(
        tag, tc, tp, timed, card, {prefix + "closest_launches": n_c * evals,
                                   prefix + "any_launches": n_a * evals},
        warm=warm)
    if tuple(img.shape) != (H, W, 3) or not bool(
            torch.isfinite(img).all()) or float(img.sum()) <= 0.0:
        raise AssertionError(f"{tag}: image not finite and non-zero")
    probe = runs[-1]
    closest, any_ = probe.rays("closest"), probe.rays("any")
    acc = int(st["accepted"]) / (MLT_CHAINS * steps)
    if not 0.0 < acc < 1.0:
        raise AssertionError(f"{tag}: acceptance {acc}")
    if method == "mlt":
        what = (f"b {st['b']:.6f}, start (trace and resampling of "
                f"{MLT_CHAINS} uniform vectors) {st['start_s']:.3f} s")
        lead = st["start_s"]
        reads = "3 host reads a run (the start's two, b's one)"
    else:
        what = (f"b_k {', '.join(f'{k}: {b:.6f}' for k, b in st['b'].items())}"
                f", chains a group {st['alloc']}, burn-in ({st['burn_rounds']} "
                f"probe rounds of 2048 chains a group, the allocation, the "
                f"resampling and the starts' evaluation) {st['burn_s']:.3f} s")
        lead = st["burn_s"]
        reads = "one host read a probe round and one a pass (b_k)"
    log(f"{tag}: {W}x{H} depth {DEPTH}, {MLT_CHAINS} chains, {n_pass} passes "
        f"of {MLT_MUT} mutations in {dt:.3f} s ({lead:.3f} s before the "
        f"mutation loop, {100 * lead / dt:.1f}% of the call; the loop "
        f"{st['loop_s']:.3f} s): {MLT_CHAINS * steps / st['loop_s'] / 1e6:.4f} "
        f"Mmutations/s, {(closest + any_) / dt / 1e6:.4f} Mrays/s "
        f"({closest + any_} live rays counted in the timed run: {closest} "
        f"closest hit in {probe.calls['closest']} wavefronts, {any_} any "
        f"hit in {probe.calls['any']}); launches {counts}, {n_c} + {n_a} a "
        f"mutation; acceptance {acc:.4f}; {what}; peak device memory "
        f"{peak / 2**20:.1f} MiB above the scene's [{card}]")
    if method == "mlt":
        state = mlt.init_chains(scene, MLT_CHAINS, SEED, DEPTH)
        fb = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)

        def step():
            mlt.mlt_step(scene, fb, *state, 1, SEED, DEPTH)
    else:
        kmax = DEPTH + 1
        lane_k = torch.cat([torch.full((n,), k, dtype=torch.int64, device=dev)
                            for k, n in st["alloc"].items()])
        gid = torch.cat([torch.full((n,), g, dtype=torch.int64, device=dev)
                         for g, n in enumerate(st["alloc"].values())])
        u = mmlt._init_psv(lane_k.shape[0], mmlt.psv_dims(kmax), 0, SEED,
                           device=dev)
        pix, col, f = mmlt._eval_merged(scene, u, lane_k, kmax, DEPTH)
        state = (u, f, pix, col, lane_k, gid)
        n_grp = len(st["alloc"])
        fb = torch.zeros((n_grp * H * W, 3), dtype=torch.float32, device=dev)

        def step():
            mmlt._mmlt_step_merged(scene, fb, *state, 1, SEED, n_grp, kmax,
                                   DEPTH, 1024.0, 1.0, H * W)
    prof = profile_pass(pt, scene, card, tag,
                        what=f"one mutation of {state[0].shape[0]} chains",
                        run=step)
    log(f"{tag}: {host_syncs(step)} host syncs a mutation (the sync debug "
        f"mode's count), and {reads}")
    del state, fb
    return probe, counts, prof


def step_twins(tag) -> None:
    """One PSSMLT mutation and one merged MMLT mutation at
    MLT_TWIN_W^2 (bench_scene, depth DEPTH) on the card and on the CPU
    twins, each from one chain state made on the CPU: the proposals
    (`large` equal, large steps bit for bit, small steps within 1e-6 on
    the circle), the splat images by the image rule (MMLT group by group),
    the accept decisions equal on >= 99.9% of chains."""
    from hydracore_tpu_torch.integrators import mlt, mmlt
    from hydracore_tpu_torch.scene.procedural import bench_scene

    t0 = time.time()
    host = bench_scene(MLT_TWIN_W, MLT_TWIN_W, DEPTH)
    card = host.to("cuda")
    hw = MLT_TWIN_W * MLT_TWIN_W

    def proposals(what, u, key, step):
        u_c, l_c = mlt._mutate(u.cuda(), key.cuda(), step, SEED)
        u_h, l_h = mlt._mutate(u, key, step, SEED)
        u_c, l_c = u_c.cpu(), l_c.cpu()
        d = (u_c - u_h).abs()
        circ = float(torch.minimum(d, 1.0 - d).max())
        if (not torch.equal(l_c, l_h) or not torch.equal(u_c[l_h], u_h[l_h])
                or circ > 1e-6):
            raise AssertionError(f"{tag} {what}: proposals differ ({circ})")
        return circ

    def accepts(what, u0, u_card, u_cpu):
        a_c = (u_card.cpu() != u0).any(dim=1)
        a_h = (u_cpu != u0).any(dim=1)
        same = float((a_c == a_h).float().mean())
        if same < 0.999 or not 0.0 < float(a_h.float().mean()) < 1.0:
            raise AssertionError(f"{tag} {what}: accept decisions agree on "
                                 f"{same}")
        return same, float(a_h.float().mean())

    R = 4 * hw  # four chains a pixel
    state = mlt.init_chains(host, R, SEED, DEPTH)
    circ = proposals("mlt", state[0], torch.arange(R), 2)
    out_c = mlt.mlt_step(card, torch.zeros((hw, 3), device="cuda"),
                         *(x.cuda() for x in state), 2, SEED, DEPTH)
    out_h = mlt.mlt_step(host, torch.zeros((hw, 3)), *state, 2, SEED, DEPTH)
    close = pixels_close(out_c[0].cpu(), out_h[0])
    same, rate = accepts("mlt", state[0], out_c[1], out_h[1])
    log(f"{tag} PSSMLT step of {R} chains: proposals' largest small-step "
        f"difference {circ:.2e}, splat pixels within 1e-3 of the CPU's "
        f"{close:.4f}, accept decisions equal on {same:.6f} (acceptance "
        f"{rate:.4f})")
    if close < 0.99:
        raise AssertionError(f"{tag} mlt: splat image {close}")

    kmax = DEPTH + 1
    ks = list(range(2, kmax + 1))
    lane_k = torch.tensor(ks).repeat_interleave(1024)
    gid = lane_k - 2
    u = mmlt._init_psv(lane_k.shape[0], mmlt.psv_dims(kmax), 0, SEED)
    pix, col, f = mmlt._eval_merged(host, u, lane_k, kmax, DEPTH)
    key = torch.arange(u.shape[0], dtype=torch.int64) + 0x9E3779B9
    circ = proposals("mmlt", u, key, 3)
    args = (len(ks), kmax, DEPTH, 1024.0, 1.0, hw)
    out_c = mmlt._mmlt_step_merged(
        card, torch.zeros((len(ks) * hw, 3), device="cuda"),
        *(x.cuda() for x in (u, f, pix, col, lane_k, gid)), 3, SEED, *args)
    out_h = mmlt._mmlt_step_merged(host, torch.zeros((len(ks) * hw, 3)), u,
                                   f, pix, col, lane_k, gid, 3, SEED, *args)
    shares = [pixels_close(out_c[0][g * hw:(g + 1) * hw].cpu(),
                           out_h[0][g * hw:(g + 1) * hw])
              for g in range(len(ks))]
    same, rate = accepts("mmlt", u, out_c[1], out_h[1])
    log(f"{tag} MMLT step of {u.shape[0]} chains (groups k = {ks}): "
        f"proposals' largest small-step difference {circ:.2e}, splat pixels "
        f"within 1e-3 of the CPU's by group {[round(s, 4) for s in shares]}, "
        f"accept decisions equal on {same:.6f} (acceptance {rate:.4f}); "
        f"{time.time() - t0:.2f} s")
    if min(shares) < 0.99:
        raise AssertionError(f"{tag} mmlt: splat images {shares}")


# tests/test_oracle_mmlt.py's box and the strategies of its k = 3 check
MM_ORACLE_W = 12
MM_K3 = [(0, 3), (1, 2), (2, 1)]


def mirror_floor_box():
    """tests/test_mmlt.py's mirror-floor caustic box at 16x16, depth 4 (a
    0.3 x 0.3 light of 20)."""
    from hydracore_tpu_torch.scene.procedural import SceneBuilder

    b = SceneBuilder()
    m = b.lambert([0.5, 0.5, 0.5])
    mirror = b.add_material(refl_color=np.array([0.9, 0.9, 0.9], np.float32))
    b.add_box_interior(2.0, mirror, m, m, m, m)
    b.rect_light([0, 1.95, 0], 0.3, 0.3, [20.0, 20.0, 20.0])
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=16,
                   height=16, trace_depth=4)


def sds_scene():
    """tests/test_mmlt.py's bulb in a glass shell at 24x24, depth 6."""
    from hydracore_tpu_torch.scene.procedural import SceneBuilder

    b = SceneBuilder()
    m = b.lambert([0.6, 0.6, 0.6])
    glass = b.add_material(transp_color=np.array([0.95, 0.95, 0.95],
                                                 np.float32),
                           transp_gloss=1.0, transp_ior=1.5)
    b.add_box_interior(2.0, m, m, m, m, m)
    b.add_sphere([0, 0.8, 0], 0.5, glass, n_seg=24, n_ring=12)
    b.rect_light([0, 0.8, 0], 0.1, 0.1, [200.0, 200.0, 200.0])
    return b.build(cam_pos=[0.0, 0.0, 5.6], cam_lookat=[0, 0, 0], width=24,
                   height=24, trace_depth=6)


def mm_stat_job(job: str):
    """A worker process of metropolis_statistics, on the CPU twins (one
    thread): tests/test_oracle_mmlt.py's oracle images (the k = 3 strategy
    sum of OracleSBDPT, OracleMMLT at k = 3 and over k = 2..3) and its
    render_mmlt at k = 2..3, or tests/test_mmlt.py's diffuse and
    mirror-floor checks, (PT, render_mmlt)."""
    from hydracore_tpu_torch.integrators import mmlt
    from hydracore_tpu_torch.integrators import pt as ptm
    from hydracore_tpu_torch.integrators.oracle import OracleMMLT

    torch.set_num_threads(1)
    if job == "diffuse":
        box = bd_cornell()
        return (ptm.render(box, spp=128, seed=3, device="cpu").numpy(),
                mmlt.render_mmlt(box, 24, 16 * 16 * 4, 8, seed=7, burn_in=5,
                                 device="cpu").numpy())
    if job == "mirror":
        box = mirror_floor_box()
        return (ptm.render(box, spp=96, seed=3, device="cpu").numpy(),
                mmlt.render_mmlt(box, 16, 16 * 16 * 4, 8, seed=7, burn_in=4,
                                 device="cpu").numpy())
    small = bd_cornell(width=MM_ORACLE_W)
    if job == "render_mmlt k=2..3":
        return mmlt.render_mmlt(small, 20, MM_ORACLE_W ** 2 * 4, 8, seed=7,
                                max_depth=2, burn_in=5, device="cpu").numpy()
    omm = OracleMMLT(small)
    if job == "strategies k=3":
        return sum(omm.o.render_strategy(s, t, spp=24, seed=29 + s + 7 * t)
                   for s, t in MM_K3)
    if job == "metropolis k=3":
        return omm.render([3], n_chains=24, n_steps=220, n_pool=400, seed=5)
    return omm.render([2, 3], n_chains=24, n_steps=220, n_pool=400, seed=11)


def metropolis_statistics(card, pt, dev, meanwhile=None) -> None:
    """The statistical checks of tests/test_mmlt.py and
    tests/test_oracle_mmlt.py that the CPU tests leave out, unchanged, at
    their own sizes, counts, seeds and limits: render_mmlt against a
    192-pass SBDPT on the bulb in a glass shell, and better than PT there,
    on `dev` (the card), while worker processes run the others on the CPU
    twins (render_mmlt is host-bound at these chain counts, 0.1-0.8 s a
    mutation on the card, and the 64^2 steps hold the card's mutation to
    the CPU's): render_mmlt against PT on the diffuse box and on the
    mirror-floor caustic box, against OracleMMLT over k = 2..3, and
    OracleMMLT at k = 3 against the k = 3 strategy sum of OracleSBDPT.
    `meanwhile()` runs after the card's check."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from hydracore_tpu_torch.integrators import bdpt, mmlt

    t0 = time.time()
    jobs = ["diffuse", "mirror", "render_mmlt k=2..3", "strategies k=3",
            "metropolis k=3", "oracle k=2..3"]
    with ProcessPoolExecutor(
            len(jobs), mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = {job: ex.submit(mm_stat_job, job) for job in jobs}
        sds = sds_scene()
        fl = bdpt.render_bdpt(sds, 192, seed=11, max_depth=6,
                              device=dev).cpu().numpy().mean(axis=-1)
        region = fl > max(np.percentile(fl, 50), 1e-6)
        if not np.isfinite(fl).all() or region.sum() < 50:
            raise AssertionError("phase 19 SDS: the SBDPT reference")
        ref_pt = pt.render(sds, spp=48, seed=3, max_depth=6,
                           device=dev).cpu().numpy().mean(axis=-1)
        mm = mmlt.render_mmlt(sds, 12, 24 * 24 * 4, 8, seed=7, burn_in=6,
                              device=dev).cpu().numpy()
        rel = abs(mm.mean() - fl.mean()) / fl.mean()
        r = fl[region]
        e_pt = float(np.median(np.abs(ref_pt[region] - r)
                               / np.maximum(r, 1e-9)))
        e_mm = float(np.median(np.abs(mm.mean(axis=-1)[region] - r)
                               / np.maximum(r, 1e-9)))
        if not (rel < 0.25 and e_mm < 0.5 * e_pt):
            raise AssertionError(f"phase 19 SDS: mean {rel}, median errors "
                                 f"MMLT {e_mm} PT {e_pt}")
        log(f"phase 19 statistics on {dev} ({time.time() - t0:.2f} s): bulb "
            f"in a glass shell: mean {rel:.2%} off the SBDPT reference, "
            f"median error MMLT {e_mm:.3f} against PT {e_pt:.3f}")
        if meanwhile is not None:
            meanwhile()
        t1 = time.time()
        res = {job: fut.result() for job, fut in futures.items()}
    checks = {
        "diffuse box against PT": bd_against_pt(
            "phase 19 MMLT diffuse", *res["diffuse"], 0.15, 0.15, 0.05)}
    ref, got = res["mirror"]
    ratio = got.mean() / ref.mean()
    if not 0.3 < ratio < 3.0:
        raise AssertionError(f"phase 19 MMLT mirror caustic: {ratio}")
    checks["mirror caustic"] = f"MMLT / PT mean {ratio:.4f}"
    ref = res["strategies k=3"]
    checks["OracleMMLT k=3 against the strategy sum"] = bd_against_pt(
        "phase 19 OracleMMLT k=3", ref, res["metropolis k=3"], 0.20, 0.30,
        0.05 * max(ref.mean(), 1e-9), n=3)
    ref = res["oracle k=2..3"]
    checks["render_mmlt k=2..3 against OracleMMLT"] = bd_against_pt(
        "phase 19 MMLT against OracleMMLT", ref, res["render_mmlt k=2..3"],
        0.20, 0.30, 0.05 * max(ref.mean(), 1e-9), n=3)
    log(f"phase 19 statistics on the CPU twins (waited {time.time() - t1:.2f}"
        f" s for {len(jobs)} workers): "
        + "; ".join(f"{k}: {v}" for k, v in checks.items()))
    log(f"phase 19 statistics: {time.time() - t0:.2f} s")


def metropolis_phase(card, pt, tc, tp, dev, host_inst, host_pkt) -> list:
    """Phase 19: PSSMLT and MMLT at WIDTH x HEIGHT, depth DEPTH, seed SEED,
    MLT_CHAINS chains. render_mlt on the flat scene (B1, B2; N_PASS passes
    of MLT_MUT mutations, the first a burn-in pass) and on phase 8's packet
    scene (B4, one pass; no packet at MAX_VISITS), render_mmlt on the flat
    scene (N_PASS passes) and on phase 6's instanced scene (B3, one pass):
    each timed with its launch counters (exact counts), Mmutations/s,
    Mrays/s, acceptance, b / b_k, peak memory, and one mutation profiled;
    B1/B2, B4 and B3 against their twins on the first mutation's camera
    wavefront (chain order) and first sorted bounce and shadow wavefronts
    (MLT) or first connection wavefront (MMLT); the statistical checks
    (metropolis_statistics) and, while its workers finish, one step of
    each on the card against the CPU twins at 64^2 (step_twins). Returns
    the "kernels" rows of the new paths."""
    from hydracore_tpu_torch.integrators import mlt
    from hydracore_tpu_torch.scene.procedural import bench_scene

    t0 = time.time()
    scene = bench_scene(WIDTH, HEIGHT, DEPTH).to(dev)
    probe, mlt_counts, _ = metropolis_run("phase 19 PSSMLT flat", pt, tc, tp,
                                          scene, card, "", "mlt", N_PASS)
    mlt_recs = check_kernels("phase 19 PSSMLT flat", tc, scene,
                             cluster_cases(tc, probe.raw_at()), card)
    del probe
    probe, mmlt_counts, _ = metropolis_run("phase 19 MMLT flat", pt, tc, tp,
                                           scene, card, "", "mmlt", N_PASS)
    mmlt_recs = check_kernels("phase 19 MMLT flat", tc, scene,
                              cluster_cases(tc, probe.raw_at()), card)
    del probe, scene
    log(f"phase 19 flat: {time.time() - t0:.2f} s")

    t0 = time.time()
    pkt_scene = host_pkt.to(dev)
    probe, pkt_counts, _ = metropolis_run("phase 19 PSSMLT packet", pt, tc,
                                          tp, pkt_scene, card, "pkt_", "mlt",
                                          1)
    packet_peak("phase 19 PSSMLT packet", tp, lambda: mlt.render_mlt(
        pkt_scene, 1, MLT_CHAINS, 1, SEED, DEPTH, burn_in=0, device=dev))
    pkt_recs = check_packet("phase 19 PSSMLT packet", tp, pkt_scene,
                            probe.raw_at(), card)
    del probe, pkt_scene
    log(f"phase 19 packet: {time.time() - t0:.2f} s")

    t0 = time.time()
    inst_scene = host_inst.to(dev)
    probe, inst_counts, _ = metropolis_run("phase 19 MMLT instanced", pt, tc,
                                           tp, inst_scene, card, "inst_",
                                           "mmlt", 1)
    inst_recs = check_kernels("phase 19 MMLT instanced", tc, inst_scene,
                              cluster_cases(tc, probe.raw_at()), card)
    del probe, inst_scene
    log(f"phase 19 instanced: {time.time() - t0:.2f} s")

    metropolis_statistics(card, pt, dev,
                          meanwhile=lambda: step_twins("phase 19 64x64"))

    at = "hydracore_tpu/ops/traverse_cluster.py"
    b12 = ("B1 cluster traversal", "B2 cluster traversal")
    b3 = ("B3 cluster traversal", "B3 cluster traversal")
    b4 = ("B4 packet traversal", "B4 packet traversal")
    return (kernel_rows(b12, "flat pool Cp 384, PSSMLT's 2^20-chain "
                        "wavefronts", CLUSTER_CU, f"{at}:576", mlt_recs,
                        (mlt_counts["closest_launches"],
                         mlt_counts["any_launches"]))
            + kernel_rows(b12, "flat pool Cp 384, MMLT's 2^20-chain "
                          "wavefronts", CLUSTER_CU, f"{at}:576", mmlt_recs,
                          (mmlt_counts["closest_launches"],
                           mmlt_counts["any_launches"]))
            + kernel_rows(b3, f"instanced Ci {host_inst.cl_map.shape[1]}, "
                          "MMLT's 2^20-chain wavefronts", CLUSTER_CU,
                          f"{at}:394", inst_recs,
                          (inst_counts["inst_closest_launches"],
                           inst_counts["inst_any_launches"]))
            + kernel_rows(b4, f"{host_pkt.wbvh_nodes.shape[0]} wide nodes, "
                          "PSSMLT's unsorted 2^20-chain wavefronts",
                          PACKET_CU, "hydracore_tpu/ops/traverse_packet.py:204",
                          pkt_recs, (pkt_counts["pkt_closest_launches"],
                                     pkt_counts["pkt_any_launches"])))


# ----------------------------------------------------------------------------
# Phase 20: the front ends (the CLI, the camera plugins, the viewer), the
# mesh on NCCL (a world of 1) and the utils
# ----------------------------------------------------------------------------

FRONT_W = 256  # the width of the routes, the resume and the shared image
FRONT_GRID = 12  # small boxes a side on the flat library's floor
FRONT_BALLS = 20  # 25,280-triangle spheres of the instanced library
# depth of the short library: the Metropolis routes (the CLI's 8 passes of
# 16 mutations at least, each mutation a host-bound wavefront) and the
# viewer's steps; mmlt_burn_iters 1 there (one probe round)
FRONT_SHORT_DEPTH = 2


def front_library(root: str, size: int, **kw) -> str:
    """scene/library.py's library at size x size with phase 20's settings:
    depth DEPTH, seed SEED, 16 spp and a FRONT_GRID^2 field of small boxes
    (the cluster route over a flat pool); `kw` overrides them (balls=,
    depth=, burn_iters=)."""
    from hydracore_tpu_torch.scene.library import write_library

    return write_library(root, size, **{"depth": DEPTH, "spp": 16, "seed": SEED,
                                        "grid": FRONT_GRID, **kw})


def run_cli(tag, tc, tp, argv, expect: set, device=None) -> tuple:
    """The port's CLI in this process (main(argv, device)) with the launch
    counters set to 0 just before and read just after: each counter named
    in `expect` must be > 0, and at least one must be. Returns (stdout,
    seconds, counts); the CLI's lines are echoed."""
    import contextlib
    import io

    from hydracore_tpu_torch.app import cli

    reset_launch_counts(tc, tp)
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device=device)
    if device is None:
        torch.cuda.synchronize()
    dt = time.time() - t0
    counts = launch_counts(tc, tp)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"{tag} | {line}")
    if rc != 0:
        raise AssertionError(f"{tag}: the CLI returned {rc}")
    if device is None and (not expect
                           or any(counts[k] <= 0 for k in expect)):
        raise AssertionError(f"{tag}: launch counts {counts}, expected "
                             f"{sorted(expect)} > 0")
    log(f"{tag}: {dt:.3f} s, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return out, dt, counts


def cli_speed(out: str) -> float:
    """The Msamples/s of the CLI's last [pass] line."""
    return float(re.findall(r"speed = ([0-9.]+) M\(samples\)/s", out)[-1])


def front_cli(tag, pt, tc, tp, flat, lib, work, card, dev) -> None:
    """The CLI's PT at 1024x1024, 16 spp in two chunks of 8, against
    render_passes over the same passes; the host time a pass adds when
    every chunk writes its PNG, checkpoint and shared-image delta."""
    from hydracore_tpu_torch.utils.checkpoint import save_checkpoint
    from hydracore_tpu_torch.utils.framebuffer import hdr_to_ldr, save_png
    from hydracore_tpu_torch.utils.shared_image import SharedAccumImage

    ck = os.path.join(work, "pt1024.npz")
    expect = {"closest_launches", "any_launches"}
    warm = ["-inputlib", lib, "-out", os.path.join(work, "warm.png"),
            "-spp", "1", "-width", str(FRONT_W), "-height", str(FRONT_W)]
    run_cli(f"{tag} warm-up", tc, tp, warm, expect)
    out, wall, counts = run_cli(
        f"{tag} PT 1024", tc, tp, ["-inputlib", lib, "-out",
                                   os.path.join(work, "pt1024.png"),
                                   "-spp", "16", "-checkpoint", ck], expect)
    if out.count("[pass] spp = ") != 1 or "spp = 16/16" not in out:
        raise AssertionError(f"{tag}: the pass lines {out}")
    msps = cli_speed(out)
    fb, spp, seed = (lambda z: (z["fb_sum"], int(z["spp"]), int(z["seed"])))(
        np.load(ck))
    if (spp, seed, fb.shape) != (16, SEED, (WIDTH, HEIGHT, 3)):
        raise AssertionError(f"{tag}: checkpoint {spp}, {seed}, {fb.shape}")
    scene = flat.to(dev)
    torch.cuda.synchronize()
    t0 = time.time()
    ref = None
    for base in (0, 8):
        img, _ = pt.render_passes(scene, base, SEED, n_pass=8,
                                  max_depth=DEPTH, device=dev)
        ref = img if ref is None else ref + img
    torch.cuda.synchronize()
    dt = time.time() - t0
    close = pixels_close(torch.as_tensor(fb) / 16, ref.cpu() / 16)
    log(f"{tag} PT 1024x1024 depth {DEPTH} 16 spp: the CLI prints "
        f"{msps:.2f} Msamples/s, {wall:.2f} s wall (scene load and PNG "
        f"included); render_passes over the same two chunks of 8 "
        f"{dt:.3f} s, {16 * WIDTH * HEIGHT / dt / 1e6:.4f} Msamples/s; "
        f"checkpoint against render_passes: pixels within 1e-3 {close:.4f}; "
        f"B1 {counts['closest_launches']}, B2 {counts['any_launches']} "
        f"launches [{card}]")
    if close < 0.99:
        raise AssertionError(f"{tag}: checkpoint vs render_passes {close}")
    # the host work of a snapshot, each part alone at 1024x1024 ...
    cur = ref.cpu().numpy()
    parts = {}
    name = f"front_{os.getpid()}"
    shimg = SharedAccumImage.attach_or_create(name, WIDTH, HEIGHT)
    try:
        for part, run in (
                ("png", lambda: save_png(os.path.join(work, "snap.png"),
                                         hdr_to_ldr(cur / 16, gamma=2.2))),
                ("checkpoint", lambda: save_checkpoint(
                    os.path.join(work, "snap.npz"), cur, 16, SEED)),
                ("shared image", lambda: shimg.add(cur, 16))):
            t0 = time.time()
            run()
            parts[part] = (time.time() - t0) * 1e3
    finally:
        shimg.unlink()
    # ... and inside the CLI: every chunk writes all three
    out_s, wall_s, _ = run_cli(
        f"{tag} PT 1024 snapshots", tc, tp,
        ["-inputlib", lib, "-out", os.path.join(work, "snap1024.png"),
         "-spp", "16", "-saveinterval", "1e-9", "-checkpoint",
         os.path.join(work, "snap1024.npz"), "-sharedimage", name + "_cli"],
        expect)
    SharedAccumImage.attach(name + "_cli").unlink()
    log(f"{tag} snapshot at 1024x1024: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in parts.items())
        + f"; the CLI with a snapshot every chunk {wall_s:.2f} s against "
        f"{wall:.2f} s: {(wall_s - wall) / 16 * 1e3:.1f} ms a pass, "
        f"{cli_speed(out_s):.2f} against {msps:.2f} printed Msamples/s "
        f"[{card}]")


FRONT_ROUTES = [
    ("raytracing", ["-method", "raytracing"]),
    ("lt", ["-method", "lt"]),
    ("sbdpt", ["-method", "sbdpt"]),
    ("ibpt", ["-method", "ibpt"]),
    ("mlt", ["-method", "mlt"]),
    ("mmlt", ["-method", "mmlt", "-mmltthreads", "16384"]),
    ("offline_pt", ["-offline_pt", "1"]),
    ("multichip (NCCL world of 1)", ["-multichip", "1"]),
    ("regen", ["-regen", "1"]),
    ("layer direct", ["-layer", "direct"]),
    ("evalgbuffer", ["-evalgbuffer", "1"]),
    ("denoise bilateral", ["-denoise", "bilateral"]),
    ("denoise nlm", ["-denoise", "nlm"]),
    ("stat", ["-stat", "1"]),
]


def front_routes(tag, tc, tp, lib, short_lib, inst_lib, work) -> None:
    """Every route and flag of the CLI at FRONT_W^2, 4 spp, each with its
    launch counters read: B1/B2 on the flat library (MLT and MMLT on the
    short one), B3 on the instanced one."""
    expect = {"closest_launches", "any_launches"}
    size = ["-spp", "4", "-width", str(FRONT_W), "-height", str(FRONT_W)]
    for name, flags in FRONT_ROUTES:
        out_png = os.path.join(work, f"{name.split()[0]}.png")
        src = short_lib if name in ("mlt", "mmlt") else lib
        out, dt, _ = run_cli(f"{tag} {name}", tc, tp,
                             ["-inputlib", src, "-out", out_png] + size + flags,
                             expect)
        if name.startswith("multichip") and "[mesh] 1 devices" not in out:
            raise AssertionError(f"{tag}: {name} did not take the mesh")
        if name == "stat" and "[stat] rays/sec(" not in out:
            raise AssertionError(f"{tag}: no [stat] line")
        if name == "evalgbuffer" and not os.path.exists(
                out_png.rsplit(".", 1)[0] + "_normal.png"):
            raise AssertionError(f"{tag}: no G-buffer images")
        if not os.path.exists(out_png):
            raise AssertionError(f"{tag}: {name} wrote no image")
    # -multichip with -method lt is single-device LT (the route order)
    out, _, _ = run_cli(f"{tag} multichip + lt", tc, tp,
                        ["-inputlib", lib, "-out", os.path.join(work, "mclt.png")]
                        + size + ["-multichip", "1", "-method", "lt"], expect)
    if "[mesh]" in out:
        raise AssertionError(f"{tag}: -method lt took the mesh")
    run_cli(f"{tag} instanced library PT", tc, tp,
            ["-inputlib", inst_lib, "-spp", "4", "-out",
             os.path.join(work, "inst.png")],
            {"inst_closest_launches", "inst_any_launches"})


def front_resume(tag, tc, tp, lib, work) -> None:
    """8 + 8 passes through a checkpoint against a straight 16, and a run
    stopped early through the exitnow mailbox."""
    base = ["-inputlib", lib, "-width", str(FRONT_W), "-height", str(FRONT_W)]
    expect = {"closest_launches", "any_launches"}
    ck = {k: os.path.join(work, f"{k}.npz") for k in ("a", "b", "s")}
    run_cli(f"{tag} resume 8", tc, tp, base + [
        "-out", os.path.join(work, "a.png"), "-spp", "8", "-checkpoint",
        ck["a"]], expect)
    run_cli(f"{tag} resume +8", tc, tp, base + [
        "-out", os.path.join(work, "b.png"), "-spp", "16", "-resume", ck["a"],
        "-checkpoint", ck["b"]], expect)
    run_cli(f"{tag} straight 16", tc, tp, base + [
        "-out", os.path.join(work, "s.png"), "-spp", "16", "-checkpoint",
        ck["s"]], expect)
    fb_b, fb_s = (np.load(ck[k])["fb_sum"] for k in "bs")
    close = pixels_close(torch.as_tensor(fb_b) / 16, torch.as_tensor(fb_s) / 16)
    log(f"{tag}: 8 + 8 resumed against a straight 16: pixels within 1e-3 "
        f"{close:.4f}")
    if close < 0.99 or int(np.load(ck["b"])["spp"]) != 16:
        raise AssertionError(f"{tag}: resume {close}")
    out_png = os.path.join(work, "stop.png")
    with open(out_png + ".ctl", "w") as f:
        f.write("exitnow")
    out, _, _ = run_cli(f"{tag} exitnow", tc, tp, base + [
        "-out", out_png, "-spp", "64"], expect)
    if "[exitnow] stopping at spp=8" not in out or os.path.exists(
            out_png + ".ctl"):
        raise AssertionError(f"{tag}: exitnow")


def front_shared(tag, lib, work) -> None:
    """Two CLI processes on the one card (python -m
    hydracore_tpu_torch.app.cli, different -seed) add into one shared
    image: the combined spp is the sum of theirs."""
    from hydracore_tpu_torch.utils.shared_image import SharedAccumImage

    name = f"front_{os.getpid()}_merge"
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hydracore_tpu_torch.app.cli", "-inputlib", lib,
         "-out", os.path.join(work, f"merge{seed}.png"), "-spp", "8",
         "-width", str(FRONT_W), "-height", str(FRONT_W), "-seed", str(seed),
         "-sharedimage", name, "-checkpoint",
         os.path.join(work, f"merge{seed}.npz")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for seed in (1, 2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"{tag}: a CLI process failed:\n{text[-3000:]}")
    img = SharedAccumImage.attach(name)
    try:
        fb, spp = img.read()
    finally:
        img.unlink()
    parts = [np.load(os.path.join(work, f"merge{s}.npz"))["fb_sum"] for s in (1, 2)]
    err = float(np.abs(fb - parts[0] - parts[1]).max())
    log(f"{tag}: two CLI processes, seeds 1 and 2, 8 spp each: combined spp "
        f"{spp:.0f}, |combined - sum of the two| <= {err:.3e} "
        f"({time.time() - t0:.2f} s, process start-up included)")
    if spp != 16 or err > 1e-3 * max(float(np.abs(fb).max()), 1.0):
        raise AssertionError(f"{tag}: shared image spp {spp}, error {err}")


def front_viewer(tag, tc, tp, pkt, card) -> None:
    """render_with_plugin(SimplePinholePlugin) and one InteractiveSession
    step of every method on the packet route (B4), each step timed; the
    HTTP surface of make_server on port 0."""
    import threading
    import urllib.request

    from hydracore_tpu_torch.app.cam_plugin import (SimplePinholePlugin,
                                                    render_with_plugin)
    from hydracore_tpu_torch.app.viewer import (METHODS, InteractiveSession,
                                                make_server)
    from hydracore_tpu_torch.scene.statefile import CameraDesc

    expect = {"pkt_closest_launches", "pkt_any_launches"}

    def counted(what, run, warm=False):
        if warm:
            run()
        torch.cuda.synchronize()
        reset_launch_counts(tc, tp)
        t0 = time.time()
        out = run()
        torch.cuda.synchronize()
        dt = time.time() - t0
        counts = launch_counts(tc, tp)
        if not any(counts[k] > 0 for k in expect):
            raise AssertionError(f"{tag} {what}: launch counts {counts}")
        return out, dt, counts

    R = FRONT_W * FRONT_W
    plug, dt, counts = counted("plugin", lambda: render_with_plugin(
        pkt, SimplePinholePlugin(pkt, seed=SEED), n_blocks=4, block_size=R,
        seed=SEED), warm=True)
    img = plug.image()
    if not np.isfinite(img).all() or img.mean() <= 0:
        raise AssertionError(f"{tag}: the plugin's image")
    log(f"{tag} pinhole plugin: 4 blocks of {R} rays in {dt:.3f} s, "
        f"{4 * R / dt / 1e6:.4f} Msamples/s, B4 {counts['pkt_closest_launches']}"
        f" + {counts['pkt_any_launches']} launches [{card}]")
    cam = CameraDesc(position=np.float32([0, 4, 14]), look_at=np.zeros(3, np.float32),
                     up=np.float32([0, 1, 0]), fov=40.0)
    s = InteractiveSession(pkt, cam, seed=SEED)
    for method in METHODS:
        s.set_method(method)
        _, dt, counts = counted(method, s.step)
        log(f"{tag} viewer step {method}: {dt * 1e3:.1f} ms at "
            f"{FRONT_W}x{FRONT_W}, spp {s.status()['spp']}, B4 "
            f"{counts['pkt_closest_launches']} + {counts['pkt_any_launches']} "
            f"launches [{card}]")
    s.set_method("pathtracing")
    s.step()
    server = make_server(s, port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        png = urllib.request.urlopen(base + "/frame.png", timeout=60).read()
        st = json.loads(urllib.request.urlopen(base + "/status", timeout=60).read())
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=60)
    if png[:8] != b"\x89PNG\r\n\x1a\n" or st["spp"] != 1:
        raise AssertionError(f"{tag}: HTTP surface {png[:8]}, {st}")
    log(f"{tag} viewer HTTP: /frame.png {len(png)} bytes, /status {st}")


def front_twins(tag, lib, work) -> None:
    """64x64 card against CPU: the CLI's PT through the checkpoint's float
    sum, and the pinhole plugin on the same numpy rays."""
    from hydracore_tpu_torch.app import cli
    from hydracore_tpu_torch.app.cam_plugin import (SimplePinholePlugin,
                                                    render_with_plugin)
    from hydracore_tpu_torch.scene.scene import load_scene

    fbs = {}
    for dev in ("cuda", "cpu"):
        ck = os.path.join(work, f"twin_{dev}.npz")
        t0 = time.time()
        cli.main(["-inputlib", lib, "-out", os.path.join(work, f"twin_{dev}.png"),
                  "-spp", "4", "-width", "64", "-height", "64", "-checkpoint",
                  ck], device=None if dev == "cuda" else "cpu")
        fbs[dev] = torch.as_tensor(np.load(ck)["fb_sum"]) / 4
        log(f"{tag} CLI 64x64 4 spp on the {dev}: {time.time() - t0:.2f} s")
    close = pixels_close(fbs["cuda"], fbs["cpu"])
    small = load_scene(lib, 64, 64)
    imgs = {}
    for dev in ("cuda", "cpu"):
        plug = render_with_plugin(small, SimplePinholePlugin(small, seed=SEED),
                                  n_blocks=2, block_size=64 * 64, seed=SEED,
                                  device=dev)
        imgs[dev] = torch.as_tensor(plug.image())
    close_p = pixels_close(imgs["cuda"], imgs["cpu"])
    log(f"{tag} 64x64 card against CPU: the CLI's checkpoint {close:.4f}, the "
        f"pinhole plugin {close_p:.4f} of pixels within 1e-3")
    if close < 0.99 or close_p < 0.99:
        raise AssertionError(f"{tag}: card vs CPU {close}, {close_p}")


def front_ends_phase(card, pt, tc, tp, dev) -> None:
    """Phase 20: the front ends on statefile libraries written here. The
    CLI's PT at 1024x1024 against render_passes; every route at
    FRONT_W^2 (B1/B2 on the flat library, B3 on the instanced one);
    resume, exitnow, two CLI processes on one shared image; the pinhole
    plugin and the viewer's steps on the packet route (B4) and its HTTP
    surface; 64x64 card against CPU."""
    from hydracore_tpu_torch.ops import trace_api
    from hydracore_tpu_torch.scene.scene import load_scene
    from hydracore_tpu_torch.utils.build import BUILD_DIR

    tag = "phase 20"
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="front_", dir=BUILD_DIR)
    try:
        t0 = time.time()
        lib = front_library(os.path.join(work, "flat"), WIDTH)
        short_lib = front_library(os.path.join(work, "short"), FRONT_W,
                                  depth=FRONT_SHORT_DEPTH, burn_iters=1)
        inst_lib = front_library(os.path.join(work, "inst"), FRONT_W,
                                 balls=FRONT_BALLS)
        flat = load_scene(lib)
        inst = load_scene(inst_lib)
        pkt = load_scene(short_lib, traversal="packet")
        for name, sc in (("flat", flat), ("instanced", inst), ("packet", pkt)):
            log(f"{tag} {name} library: {sc.num_triangles} triangles, "
                f"{sc.camera.width}x{sc.camera.height}, route "
                f"{trace_api._pick(sc).__name__.rsplit('.', 1)[-1]}, cluster pool "
                f"{tuple(sc.cl_tris.shape[:-2])}, instanced "
                f"{sc.settings.has_inst}")
        if (trace_api._pick(flat) is not tc or flat.settings.has_inst
                or not inst.settings.has_inst or trace_api._pick(pkt) is not tp):
            raise AssertionError(f"{tag}: the libraries' layouts")
        log(f"{tag} libraries written and loaded: {time.time() - t0:.2f} s")
        t0 = time.time()
        front_cli(tag, pt, tc, tp, flat, lib, work, card, dev)
        log(f"{tag} CLI at 1024: {time.time() - t0:.2f} s")
        t0 = time.time()
        front_routes(tag, tc, tp, lib, short_lib, inst_lib, work)
        log(f"{tag} routes: {time.time() - t0:.2f} s")
        t0 = time.time()
        front_resume(tag, tc, tp, lib, work)
        front_shared(tag, lib, work)
        log(f"{tag} resume, exitnow, shared image: {time.time() - t0:.2f} s")
        t0 = time.time()
        front_viewer(tag, tc, tp, pkt.to(dev), card)
        log(f"{tag} plugin and viewer: {time.time() - t0:.2f} s")
        t0 = time.time()
        front_twins(tag, lib, work)
        log(f"{tag} card against CPU: {time.time() - t0:.2f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)


CLUSTER_CU = "hydracore_tpu_torch/csrc/traverse_cluster.cu"
PACKET_CU = "hydracore_tpu_torch/csrc/traverse_packet.cu"
DENSE_CU = "hydracore_tpu_torch/csrc/traverse_dense.cu"
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
    """T7 at the tool's size: gather() (the window path there) and the
    direct kernel, both variants, bit for bit against the plain version (any
    NaN matching any NaN) on the tool's inputs and on t7.adversarial_inputs,
    which launch both paths and the window path's wrapping rows; timed
    beside the plain version and beside embedding_bag over the same (R, 16)
    index matrix (built outside the timed call); then the tool's main()."""
    from hydracore_tpu_torch.tools import bench_pallas_gather as t7

    pool, idx = t7.inputs(device=dev)
    S = pool.shape[0]
    idx16 = (idx.long() + torch.arange(t7.ITERS, device=idx.device)) % S
    adversarial = t7.adversarial_inputs(dev)
    recs = {}
    for name, onehot in t7.VARIANTS.items():
        t7.reset_launch_counts()
        out_k = t7.gather(pool, idx, onehot=onehot)
        out_d = t7.gather_direct(pool, idx, onehot=onehot)
        out_p = t7.gather_plain(pool, idx, onehot=onehot)
        torch.cuda.synchronize()
        if not (t7.same_bits(out_k, out_p) and t7.same_bits(out_d, out_p)):
            raise AssertionError(f"phase 12 T7 {name}: kernel differs from plain")
        wrapping = 0
        for case, (p, i, iters) in adversarial.items():
            got = t7.gather(p, i, iters, onehot)
            direct = t7.gather_direct(p, i, iters, onehot)
            want = t7.gather_plain(p, i, iters, onehot)
            if not (t7.same_bits(got, want) and t7.same_bits(direct, want)):
                raise AssertionError(f"phase 12 T7 {name} on {case}: kernel "
                                     "differs from plain")
            if t7.uses_window(i.shape[0], p.shape[0], iters):
                wrapping += t7.wrapping_rows(i, p.shape[0], iters)
        paths = {path: t7.launches[(name, path)] for path in t7.PATHS}
        if min(paths.values()) == 0 or wrapping == 0:
            raise AssertionError(f"phase 12 T7 {name}: launches by path "
                                 f"{paths}, wrapping rows {wrapping}")
        rows = pool.to(torch.bfloat16).to(torch.float32) if onehot else pool
        lib = torch.nn.functional.embedding_bag(idx16, rows, mode="sum")
        lib_err = float((lib - out_k).abs().max())
        plain = lab.time_ms(lambda: t7.gather_plain(pool, idx, onehot=onehot),
                            3, dev)
        lib_ms = lab.time_ms(lambda: torch.nn.functional.embedding_bag(
            idx16, rows, mode="sum"), 5, dev)
        log(f"phase 12 T7 {name}: both paths equal to the plain version, "
            f"also on {', '.join(adversarial)} (launches by path {paths}, "
            f"{wrapping} wrapping rows summed directly); plain {plain:.4f} "
            f"ms, embedding_bag {lib_ms:.4f} ms (max abs diff {lib_err:.3e}: "
            f"another summation order) [{card}]")
        recs[name] = (plain, lib_ms)
    t7.reset_launch_counts()
    res = t7.main(device=dev)
    at = "tools/bench_pallas_gather.py"
    kernels = []
    for name in t7.VARIANTS:
        replaces = f"{at}:{32 if name == 'taa' else 43}"
        bound = (res[name]["bound_ms"], res[name]["bound_by"])
        kernels += [lab_row(f"T7 row gather, {name} (gather(): "
                            f"{res[name]['path']} path)", "lab_gather.cu",
                            replaces, t7.launches[(name, res[name]["path"])],
                            0.0, res[name]["ms"], recs[name][0], bound,
                            recs[name][1]),
                    lab_row(f"T7 row gather, {name} (direct kernel)",
                            "lab_gather.cu", replaces,
                            t7.launches[(name, "direct")], 0.0,
                            res[f"{name} direct"]["ms"], recs[name][0],
                            bound, recs[name][1])]
    return kernels


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


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits: torch.equal is false on NaN."""
    return t.contiguous().view(torch.int32)


def us_spread(ms: float, spread) -> str:
    return f"{ms * 1e3:.3f} us ({spread[0] * 1e3:.3f}-{spread[1] * 1e3:.3f})"


def lab_prims(card, dev="cuda") -> list:
    """T6: each probe equal to its plain version bit for bit on the tool's
    x and xi and on k8's adversarial inputs (t6.adversarial_inputs: a NaN,
    a row of -inf, ties of -0.0 and +0.0), and, where there is one, to the
    one-call PyTorch form (prim_library); the plain version timed beside
    it; then the tool's main() (its counter read), which times the launch
    floor (an empty kernel) and each probe; then each probe, the floor and
    the probe's library call in turns (interleaved: graphs of
    t6.GRAPH_CALLS calls, 4 times each), the times of the "kernels" rows."""
    from hydracore_tpu_torch.tools import proto_prims as t6

    x, xi = t6.inputs(dev)
    library = prim_library(x, xi)
    adversarial = t6.adversarial_inputs(dev)
    plain = {}
    for k in t6.NAMES:
        out_k = t6.prim(k, x, xi)
        if not torch.equal(bits(out_k), bits(t6.prim_plain(k, x, xi))):
            raise AssertionError(f"phase 12 T6 k{k}: kernel differs from plain")
        for name, (xa, xia) in adversarial.items():
            if not torch.equal(bits(t6.prim(k, xa, xia)),
                               bits(t6.prim_plain(k, xa, xia))):
                raise AssertionError(f"phase 12 T6 k{k} on {name}: kernel "
                                     "differs from plain")
        if k in library and not torch.equal(out_k, library[k]()):
            raise AssertionError(f"phase 12 T6 k{k}: the library call differs")
        plain[k] = lab.time_ms(lambda: t6.prim_plain(k, x, xi), 20, dev)
    k8 = {name: float(t6.prim(8, xa, xia)[0, 0])
          for name, (xa, xia) in adversarial.items()}
    log("phase 12 T6: the ten probes equal their plain versions bit for bit "
        f"on the tool's inputs and on {', '.join(adversarial)} (k8 there: "
        + ", ".join(f"{n} {v!r}" for n, v in k8.items()) + "), and the "
        f"library calls of k{', k'.join(map(str, library))} [{card}]")
    t6.reset_launch_counts()
    res = t6.main(device=dev)
    n = t6.prim_launches
    res.pop("floor")
    if not all(r["ok"] for r in res.values()):
        raise AssertionError("phase 12 T6: a probe failed in main()")
    times = {}
    for k in t6.NAMES:
        fns = {"kernel": lambda: t6.prim(k, x, xi),
               "floor": lambda: t6.empty(dev)}
        if k in library:
            fns["library"] = library[k]
        times[k] = tm = lab.interleaved(fns, t6.GRAPH_CALLS, dev)
        (ms, sp), (fl, _) = tm["kernel"], tm["floor"]
        line = (f"phase 12 T6 k{k} in turns with the floor"
                f"{' and its library call' if k in library else ''}, graphs "
                f"of {t6.GRAPH_CALLS}, 4 times: {us_spread(ms, sp)}, floor "
                f"{us_spread(fl, tm['floor'][1])}: {ms / fl:.2f}x the floor")
        if k in library:
            lms, lsp = tm["library"]
            within = sp[0] <= lsp[1] and lsp[0] <= sp[1]
            verdict = ("no slower" if ms <= lms else
                       "slower, within the spread" if within
                       else "slower, outside the spread")
            line += (f"; library {us_spread(lms, lsp)}: {verdict} "
                     f"(x{ms / lms:.3f})")
        if k == 8:
            line += f"; within 2x the floor: {'yes' if ms <= 2 * fl else 'no'}"
        log(f"{line} [{card}]")
    lines = {1: 35, 2: 45, 3: 54, 4: 64, 5: 73, 6: 83, 7: 93, 8: 116,
             9: 126, 10: 135}
    rows = []
    for k in t6.NAMES:
        tm = times[k]
        row = lab_row(f"T6 probe k{k} ({t6.NAMES[k]}; launches of all ten)",
                      "lab_prims.cu", f"tools/proto_prims.py:{lines[k]}", n,
                      0.0, tm["kernel"][0], plain[k],
                      (res[f"k{k}"]["bound_ms"], res[f"k{k}"]["bound_by"]),
                      tm["library"][0] if "library" in tm else None)
        row["launch_floor_ms"] = tm["floor"][0]
        rows.append(row)
    return rows


def lab_subvisit(card, dev="cuda") -> list:
    """T5 at the tool's size: every variant's kernel equal to its plain
    version bit for bit (every output word) on the tool's inputs and on
    t5.adversarial_inputs, timed beside it; the profiling build's counts and
    the time its SASS permits at the issue rate (t5_issue); then the tool's
    main()."""
    from hydracore_tpu_torch.tools import proto_subvisit as t5

    rays, tris, lst = t5.inputs(device=dev)
    adversarial = t5.adversarial_inputs(dev)
    recs, profs = {}, {}
    for name, (n_bands, inter) in t5.VARIANTS.items():
        out_k = t5.subvisit(rays, tris, lst, n_bands, inter)
        plain, out_p = lab.time_ms(lambda: t5.subvisit_plain(
            rays, tris, lst, n_bands, inter), 1, dev, result=True)
        prof = torch.zeros(len(t5.PROFILE), dtype=torch.int64, device=dev)
        out_f = t5.subvisit(rays, tris, lst, n_bands, inter, profile=prof)
        torch.cuda.synchronize()
        wk, wp = bits(out_k), bits(out_p)
        if not torch.equal(wk, wp):
            bad = int(torch.nonzero(wk != wp)[0, 0])
            raise AssertionError(
                f"phase 12 T5 {name}: kernel differs from plain on "
                f"{int((wk != wp).sum())} rays, first ray {bad}: words "
                f"{int(wk[bad])} / {int(wp[bad])}")
        if not torch.equal(bits(out_f), wp):
            raise AssertionError(f"phase 12 T5 {name}: the profiling build "
                                 "differs from plain")
        for case, (ra, ta, la) in adversarial.items():
            if not torch.equal(bits(t5.subvisit(ra, ta, la, n_bands, inter)),
                               bits(t5.subvisit_plain(ra, ta, la, n_bands,
                                                      inter))):
                raise AssertionError(f"phase 12 T5 {name} on {case}: kernel "
                                     "differs from plain")
        walk, kept = prof.tolist()
        profs[name] = (walk, kept)
        hits = int((out_k < 1e38).sum())
        log(f"phase 12 T5 {name}: {hits} of {out_k.numel()} rays hit, every "
            f"word equal to the plain version's, and on "
            f"{', '.join(adversarial)}; kept ray-lanes {kept} "
            f"({kept / (rays.shape[0] * (lst.shape[0] // n_bands) * t5.LANES):.4f}"
            f"), walk iterations {walk} (warps); plain {plain:.4f} ms [{card}]")
        recs[name] = plain
    t5.reset_launch_counts()
    res = t5.main(device=dev)
    t5_issue(card, t5, res, profs, rays.shape[0], lst.shape[0])
    return [lab_row(f"T5 sub-visit, {name} (launches of the "
                    f"{'plain' if name == 'plain' else 'sub'} kernel)",
                    "lab_subvisit.cu",
                    f"tools/proto_subvisit.py:{52 if name == 'plain' else 68}",
                    t5.plain_launches if name == "plain" else t5.sub_launches,
                    0.0, res[name]["ms"], recs[name],
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
    for name, (a_rays, a_oct, a_cbl) in t1.adversarial_inputs(dev).items():
        for v in t1.ALL[:-1]:
            kind, n = t1.parse(v)
            out_k, outi_k = t1.cluster_cost(kind, a_rays, a_oct, a_cbl, n)
            out_p, outi_p = t1.cluster_cost_plain(kind, a_rays, a_oct, a_cbl, n)
            torch.cuda.synchronize()
            if not (torch.equal(bits(out_k), bits(out_p))
                    and torch.equal(outi_k, outi_p)):
                raise AssertionError(f"phase 12 T1 {v} on adversarial input "
                                     f"{name}: kernel differs from plain")
        log(f"phase 12 T1 adversarial {name}: every lab variant equal to the "
            f"plain version bit for bit")
    t1.reset_launch_counts()
    tc.reset_launch_counts()
    res = t1.main("all", device=dev)
    counts = {"floor": t1.floor_launches, "fm": t1.floor_launches,
              "stagea": t1.stagea_launches, "compact": t1.compact_launches,
              "full": tc.closest_launches}
    ratio = res["stagea2"]["ms"] / res["stagea1"]["ms"]
    log(f"phase 12 T1 stagea2 / stagea1: {ratio:.3f} (every repeat a real "
        f"scan: 1.8-2.2) [{card}]")
    if not 1.8 <= ratio <= 2.2:
        raise AssertionError(f"phase 12 T1: stagea2 / stagea1 = {ratio:.3f}")
    t1_issue(card, t1, res, rays, cbl)
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
    on the same inputs, each job's time beside its bound; the MXU job
    without a hit in either; the MXU variant once more with random plane
    columns in pk, where it must hit and agree too; then
    t2.adversarial_inputs in every mode, bit for bit, and the time that the
    kernel's SASS permits (t2_issue)."""
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
        if not (torch.equal(bits(out_k), bits(out_p))
                and torch.equal(outi_k, outi_p)):
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
    for name in recs:
        r = res[name]
        log(f"phase 13 T2 {name}: {r['ms']:.4f} ms against its bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}): "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound [{card}]")
    for name, (ra, cb, tris, pk, mxu) in t2.adversarial_inputs().items():
        args = [torch.tensor(x).to(dev) for x in (ra, cb, tris, pk)]
        for mode in sorted(t2.MODES.values()):
            out_k, outi_k = t2.proto_cluster(*args, mxu, mode)
            out_p, outi_p = t2.proto_cluster_plain(*args, mxu, mode)
            if not (torch.equal(bits(out_k), bits(out_p))
                    and torch.equal(outi_k, outi_p)):
                raise AssertionError(f"phase 13 T2 adversarial {name} mode "
                                     f"{mode}: kernel differs from plain")
            if mode == 0:
                hits = int((outi_k[:, :, 0] >= 0).sum())
                lists = sorted({int(v) for v in out_k[:, 0, 1].tolist()})
        log(f"phase 13 T2 adversarial {name} (Cp {args[1].shape[1]}, R_BLK "
            f"{args[0].shape[1]}, mxu {int(mxu)}): kernel equal to the plain "
            f"version in modes 0-3; lists of {lists}, hits {hits} [{card}]")
    t2_issue(card, t2, res)
    return [lab_row(f"T2 proto cluster, {name} (launches of all eight jobs)",
                    "lab_cluster.cu", "tools/proto_cluster.py:189",
                    launches, 0.0, res[name]["ms"], recs[name],
                    (res[name]["bound_ms"], res[name]["bound_by"]))
            for name in recs]


def inner_loop(code, has) -> list:
    """The smallest loop of `code` (a backward branch and the instructions
    from its target to it) whose body holds an instruction for which
    has(opcode, operands) is true; [] if there is none."""
    best = []
    for a, op, rest in code:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op != "BRA" or not m or int(m.group(1), 16) >= a:
            continue
        body = [c for c in code if int(m.group(1), 16) <= c[0] <= a]
        if any(has(o, r) for _, o, r in body) and (not best
                                                   or len(body) < len(best)):
            best = body
    return best


def issued(code) -> tuple[list, int]:
    """The instructions of a loop body that run when no lane takes a slow
    path: without the ranges that a vote's branch skips (the division's
    warp-uniform slow path: the first BRA after a VOTE.ANY). Returns
    (instructions, how many were left out)."""
    skip = set()
    for i, (a, op, rest) in enumerate(code):
        if op == "VOTE" and rest.startswith(".ANY P"):
            for b, op2, rest2 in code[i + 1:i + 24]:  # its first branch
                m = re.search(r"0x([0-9a-f]+)", rest2)
                if op2 == "BRA" and m:
                    skip.update(c[0] for c in code
                                if b < c[0] < int(m.group(1), 16))
                    break
    kept = [c for c in code if c[0] not in skip]
    return kept, len(code) - len(kept)


def issue_rate() -> tuple[float, int, float]:
    """The card's issue rate, one warp instruction a clock on each of an
    SM's 4 schedulers at its largest SM clock: (warp instructions a second,
    SMs, MHz)."""
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 4 * clk * 1e6, sms, clk


def t1_issue(card, t1, res, rays, cbl) -> None:
    """What T1's SASS permits: in each scan kernel's code the innermost loop
    with FMNMX is the scan's (11 a ray and position: the slab test's 10 and
    max(tn, 0)); its instructions a ray and position, times the tests of
    this run's live blocks (every block of the lab's rays) and scans, over
    the card's issue rate (issue_rate), give the least time at which the
    code could run, beside the measured time and the bound."""
    code = kernel_code("phase 12 T1", "lab_cluster_cost.cu")
    rate, sms, clk = issue_rate()
    n_pos = cbl.shape[2] // 128 * 128
    live = int((rays[..., 7] > 0).any(dim=1).sum())
    tests = live * rays.shape[1] * n_pos
    for fn, own in code.items():
        m = re.search(r"scan_kernelILi(\d)E", fn)
        if not m:
            continue
        loop = inner_loop(own, lambda op, _: op == "FMNMX")
        per_test = len(loop) / max(sum(op == "FMNMX" for _, op, _ in loop) / 11, 1)
        for v in (("stagea1", "stagea2") if m.group(1) == "1"
                  else ("compact1", "compact2")):
            kind, n = t1.parse(v)
            permit = (n if kind == "stagea" else 1) * tests / 32 * per_test / rate * 1e3
            log(f"phase 12 T1 {v}: {per_test:.2f} instructions a ray and position "
                f"(the scan's loop): {permit:.5f} ms at the full issue rate "
                f"({sms} SMs x 4 x {clk:.0f} MHz), measured {res[v]['ms']:.4f} "
                f"ms, bound {res[v]['bound_ms']:.5f} ms [{card}]")


def t5_issue(card, t5, res, profs, n_rays, n_visits) -> None:
    """What T5's SASS permits: in each timed instantiation's code
    (kernel_code) the innermost loop with a VOTE is the tests of 32 lanes
    (a ballot a lane), four a step; the innermost loop with a MUFU (the
    division's reciprocal) is one iteration of the walk of kept lanes,
    which the profiling build counts (profs: a warp's iterations). Their
    instructions over the card's issue rate give the least time at which
    the code could run this run's work, beside the measured time and the
    bound (which counts an FMA as two operations)."""
    code = kernel_code("phase 12 T5", "lab_subvisit.cu")
    rate, sms, clk = issue_rate()
    for name, (n_bands, _) in t5.VARIANTS.items():
        own = next(own for fn, own in code.items() if re.search(
            rf"subvisit_kernelILi{n_bands}ELi\dELb0EE", fn))
        tests = inner_loop(own, lambda op, rest: op == "VOTE")
        walk = inner_loop(own, lambda op, _: op == "MUFU")
        per_lane = len(tests) / 32
        steps = n_visits // n_bands
        warps = n_rays // 32
        n_walk, n_kept = profs[name]
        instr = warps * steps * 4 * len(tests) + n_walk * len(walk)
        permit = instr / rate * 1e3
        log(f"phase 12 T5 {name}: {per_lane:.2f} instructions a ray and lane "
            f"(the tests, {len(tests)} a loop of 32 lanes), {len(walk)} an "
            f"iteration of the walk ({n_walk} iterations, "
            f"{n_walk * 32 / max(n_kept, 1):.2f} lanes of the warp a kept "
            f"ray-lane): {instr / 1e6:.1f}M warp instructions, {permit:.5f} ms "
            f"at the full issue rate ({sms} SMs x 4 x {clk:.0f} MHz), measured "
            f"{res[name]['ms']:.4f} ms ({permit / res[name]['ms'] * 100:.1f}% "
            f"of the rate), bound {res[name]['bound_ms']:.5f} ms [{card}]")


def t2_issue(card, t2, res) -> None:
    """What T2's SASS permits: in each instantiation's code (kernel_code)
    the innermost loop with FMNMX is stage A's (10 a ray and position), the
    innermost with a |x| > 1e-12 test stage B's over a group of lanes (one
    test a lane); the
    instructions a warp issues there on the path that takes no slow
    division (issued), for this run's positions and visits, over the card's
    issue rate (one warp instruction a clock on each of an SM's 4
    schedulers, at the card's largest SM clock), give the least time at
    which the code could run; beside the measured time and the bound,
    which counts f32 operations at the peak that takes an FMA as two."""
    code = kernel_code("phase 13 T2", "lab_cluster.cu")
    by_inst = {}
    for fn, own in code.items():
        m = re.search(r"proto_cluster_kernelILi(\d+)ELb([01])ELi(\d)E", fn)
        if m:
            key = (int(m.group(1)), m.group(2) == "1", int(m.group(3)))
            by_inst[key] = own
    rate, sms, clk = issue_rate()
    for v, a, mxu, rb in t2.JOBS:
        if v not in ("full", "novisit"):
            continue
        name = t2.job_name(v, a, mxu, rb)
        own = by_inst[(rb, mxu, t2.MODES[v])]
        node = inner_loop(own, lambda op, _: op == "FMNMX")
        pairs = sum(op == "FMNMX" for _, op, _ in node) / 10
        per_pair = len(node) / max(pairs, 1)
        leaf, skipped = issued(inner_loop(
            own, lambda op, rest: op == "FSETP" and "e-13" in rest
            and rest.startswith(".GT")))
        lanes = sum(op == "FSETP" and rest.startswith(".GT") and "e-13" in rest
                    for _, op, rest in leaf)
        per_lane = len(leaf) / max(lanes, 1)
        warps = t2.N_RAYS // 32
        visits = float(res[name]["out"][0][:, 0, 1].sum())  # over blocks
        stage_a = warps * t2.C * per_pair
        stage_b = visits * (rb // 32) * t2.K * per_lane if lanes else 0.0
        permit = (stage_a + stage_b) / rate * 1e3
        log(f"phase 13 T2 {name}: {per_pair:.2f} instructions a ray and "
            f"position (stage A), {per_lane if lanes else 0:.2f} a ray and "
            f"lane (stage B; {skipped} of the body's slow path left out): "
            f"{permit:.5f} ms at the full issue rate ({sms} SMs x 4 x "
            f"{clk:.0f} MHz), measured {res[name]['ms']:.4f} ms, bound "
            f"{res[name]['bound_ms']:.5f} ms [{card}]")


# the adversarial walks whose plain version runs on the CPU, in a worker
# process while the card runs phases 12 and 13 (thousands of small steps:
# the host's time a step, not the card's)
CPU_PLAINS = ((3, "max_visits"), (4, "max_visits"))


def cpu_walk_plains() -> dict:
    """The plain walks of CPU_PLAINS on the CPU: (tool, case) -> its
    unpacked outputs (t, slot, u, v, visits) as int32 numpy bits."""
    from hydracore_tpu_torch.tools import proto_packet as t3
    from hydracore_tpu_torch.tools import proto_packet2 as t4

    torch.set_num_threads(2)
    out = {}
    for n, case in CPU_PLAINS:
        tool = {3: t3, 4: t4}[n]
        args = tool.adversarial_inputs("cpu")[case]
        res = tool.unpack(tool.packet_traverse_plain(*args))
        out[n, case] = [x.contiguous().view(torch.int32).numpy()
                        if x.is_floating_point() else x.numpy() for x in res]
    return out


def walk_adversarial(card, tool, dev, cpu_plains) -> None:
    """tool (proto_packet or proto_packet2) on its adversarial_inputs: the
    kernel equal to the plain version bit for bit (t, slot, u, v, visits;
    the plain version of the cases in CPU_PLAINS from cpu_plains, a future
    of cpu_walk_plains)."""
    for name, args in tool.adversarial_inputs(dev).items():
        t0 = time.time()
        k = tool.unpack(tool.packet_traverse(*args))
        if (tool.TOOL, name) in CPU_PLAINS:
            p = [torch.from_numpy(x) for x in cpu_plains.result()[tool.TOOL, name]]
            where = "the CPU"
        else:
            p = tool.unpack(tool.packet_traverse_plain(*args))
            where = "the card"
        torch.cuda.synchronize()
        same = [torch.equal((bits(a) if a.is_floating_point() else a).cpu(),
                            (bits(b) if b.is_floating_point() else b).cpu())
                for a, b in zip(k, p)]
        if not all(same):
            raise AssertionError(f"phase 13 T{tool.TOOL} adversarial {name}: "
                                 f"kernel differs from plain (t, slot, u, v, "
                                 f"visits equal: {same})")
        extra = ""
        if name == "sumuv":
            extra = (f"; u NaN on {int(torch.isnan(k[2]).sum())} rays, -0.0 on "
                     f"{int((bits(k[2]) == -2 ** 31).sum())}")
        log(f"phase 13 T{tool.TOOL} adversarial {name}: kernel equal to the "
            f"plain version (on {where}) bit for bit; visits per packet "
            f"{k[4].tolist()[:16]}, hits {int((k[1] >= 0).sum())}{extra} "
            f"({time.time() - t0:.1f} s) [{card}]")


def walk_profile(card, tool, scene, rays, dev) -> dict:
    """tool's profiling build on each ray set: the packet-work bound its
    counts give (the entries x P rays x 8 x OPS_BOX a node entry, 8 x
    OPS_TRI a leaf entry, at the f32 peak), each packet's and each SM's
    cycles. Returns name -> (the profile's columns from node entries on,
    summed over packets; the unpacked outputs)."""
    nodes, tris = tool.pack_scene(scene)
    counts = {}
    for name, (ro, rd) in rays.items():
        packed = tool.pack_rays(ro, rd).to(dev)
        n_pk = rd.shape[0] // tool.P
        prof = torch.zeros((n_pk, len(tool.PROFILE)), dtype=torch.int64,
                           device=dev)
        out = tool.unpack(tool.packet_traverse(packed, nodes, tris,
                                               profile=prof))
        pr = prof.cpu()
        counts[name] = pr[:, 3:].sum(dim=0).tolist() + [out]
        n_node, n_leaf = counts[name][:2]
        work_ms, by = lab.bound_ms(0, tool.P * 8 * (n_node * OPS_BOX
                                                    + n_leaf * OPS_TRI))
        cyc = (pr[:, 1] - pr[:, 0]).double()
        # each SM's span, from its first packet's start to its last's end
        # (clock64 counts on each SM's own clock)
        span = [float(pr[pr[:, 2] == sm, 1].max() - pr[pr[:, 2] == sm, 0].min())
                for sm in pr[:, 2].unique().tolist()]
        log(f"phase 13 T{tool.TOOL} {name}: {n_node} node and {n_leaf} leaf "
            f"entries over {pr.shape[0]} packets; packet-work bound "
            f"{work_ms:.5f} ms ({by}); a packet's walk {float(cyc.mean()):.0f} "
            f"cycles on the mean, {float(cyc.max()):.0f} the most (its "
            f"{int(out[4][int(cyc.argmax())])} pops); {len(span)} SMs busy, an "
            f"SM's span {np.mean(span):.0f} cycles on the mean, {max(span):.0f}"
            f" the most; " + ", ".join(
                f"{c} {v}" for c, v in zip(tool.PROFILE[5:], counts[name][2:-1]))
            + f" [{card}]")
    return counts


def t4_checks(card, t4, scene, rays, dev, cpu_plains) -> None:
    """T4 beyond its tool's main(): walk_adversarial, walk_profile and the
    time the kernel's SASS permits at the issue rate (t4_issue)."""
    walk_adversarial(card, t4, dev, cpu_plains)
    counts = walk_profile(card, t4, scene, rays, dev)
    t4_issue(card, t4, {k: v[:4] for k, v in counts.items()})


def t3_checks(card, t3, scene, rays, dev, cpu_plains) -> None:
    """T3 beyond its tool's main(): walk_adversarial, walk_profile and the
    time the kernel's SASS permits at the issue rate (t3_issue)."""
    walk_adversarial(card, t3, dev, cpu_plains)
    t3_issue(card, t3, walk_profile(card, t3, scene, rays, dev))


def marker_sizes(tag, own, marks, loops=()) -> dict:
    """The size of each part of a profiling build's code that HYDRA_MARK
    (csrc/lab_packet.cu: PMTRIG in the SASS) starts: the median, over the
    marker's copies in the unrolled code, of the instructions from it to
    the next marker, or for a marker in `loops` of the smallest loop that
    holds it, without the ranges a vote's branch skips (issued). Raises when
    a marker of `marks` is missing."""
    at = [(i, int(re.search(r"(0x[0-9a-f]+|\d+)", rest).group(1), 0))
          for i, (_, op, rest) in enumerate(own) if op == "PMTRIG"]
    if any(v % 2 for _, v in at):  # the operand is the event, else 1 << it
        ids = [v for _, v in at]
    else:
        ids = [v.bit_length() - 1 for _, v in at]
    sizes = {k: [] for k in marks}
    for n, ((i, _), k) in enumerate(zip(at, ids)):
        if k not in sizes:
            continue
        if k in loops:
            body = []
            for b, op, rest in own:
                m = re.search(r"0x([0-9a-f]+)", rest)
                if (op == "BRA" and m and int(m.group(1), 16) <= own[i][0] <= b
                        and (not body or b - int(m.group(1), 16)
                             < body[-1][0] - body[0][0])):
                    body = [c for c in own if int(m.group(1), 16) <= c[0] <= b]
            if body:
                sizes[k].append(len(issued(body)[0]))
        else:
            j = at[n + 1][0] if n + 1 < len(at) else len(own)
            sizes[k].append(len(issued(own[i + 1:j])[0]))
    if any(not v for v in sizes.values()):
        raise AssertionError(
            f"{tag}: the profiling build's markers were not all found "
            f"({ {k: len(v) for k, v in sizes.items()} })")
    return {k: float(np.median(v)) for k, v in sizes.items()}


def t3_issue(card, t3, counts) -> None:
    """What T3's SASS permits. Its profiling build marks the start of each
    part of the walk (HYDRA_MARK: PMTRIG in the SASS): 1 a node entry, 2 a
    child's test, 3 the node's vote and pushes, 4 a leaf entry, 6 a
    triangle's first pass, 5 a triangle past it, 7 a triangle of the u and v
    sum of a ray that won; marker_sizes gives each part's size (5 and 7:
    the loop that holds the marker). The profile counts how often a warp runs each part: node and leaf
    entries, children tested (empty ones are not), triangles tested (flat
    ones are not) and past the first pass; a warp runs the sum's 8
    triangles when one of its rays won. Their product over the card's issue
    rate is the least time at which the profiling build's code could run
    this run's walk."""
    code = kernel_code("phase 13 T3", "lab_packet.cu")
    own = next(own for fn, own in code.items() if "t3_walk_kernelILb1EE" in fn)
    size = marker_sizes("phase 13 T3", own, (1, 2, 3, 4, 5, 6, 7), loops=(5, 7))
    rate, sms, clk = issue_rate()
    for name, (n_node, n_leaf, n_child, n_rest, n_tri, out) in counts.items():
        won = (out[1] >= 0).reshape(-1, t3.RPT, t3.WARPS, 32).any(dim=3)
        n_sum = int(won.sum()) * 8
        runs = {1: n_node * t3.WARPS, 2: n_child, 3: n_node * t3.WARPS,
                4: n_leaf * t3.WARPS, 6: n_tri, 5: n_rest, 7: n_sum}
        instr = sum(runs[k] * size[k] for k in runs)
        log(f"phase 13 T3 {name}: the profiling build issues (a warp) "
            f"{size[1]:.0f} a node entry, {size[2]:.0f} a child's test, "
            f"{size[3]:.0f} the vote and pushes, {size[4]:.0f} a leaf entry, "
            f"{size[6]:.0f} a triangle's first pass, {size[5]:.0f} a triangle "
            f"past it, {size[7]:.0f} a triangle of the u and v sum ({n_child} "
            f"children, {n_tri} triangles, {n_rest} past the first pass, "
            f"{n_sum // 8} sums; its code {len(own)} instructions): "
            f"{instr / 1e6:.1f}M warp instructions, {instr / rate * 1e3:.5f} "
            f"ms at the full issue rate ({sms} SMs x 4 x {clk:.0f} MHz) "
            f"[{card}]")


def t4_issue(card, t4, counts) -> None:
    """What T4's SASS permits. Its profiling build marks the start of each
    part of the walk (csrc/lab_packet.cu, HYDRA_MARK: PMTRIG in the SASS),
    and marker_sizes gives each part's size (without the division's slow
    path behind its vote). The profile counts how often a warp runs each
    part: node and leaf entries, slab tests, triangles up to and past the
    early exit. Their product, over the
    card's issue rate, is the least time at which the code could run this
    run's walk. The sizes are the profiling build's (its counters and
    markers add a few instructions); the line gives its length and the
    timed build's, whose node and leaf bodies kernel_code logs. Raises when
    a marker is missing."""
    code = kernel_code("phase 13 T4", "lab_packet.cu")
    own = next(own for fn, own in code.items() if "t4_walk_kernelILb1EE" in fn)
    timed = next(own for fn, own in code.items() if "t4_walk_kernelILb0EE" in fn)
    size = marker_sizes("phase 13 T4", own, range(1, 7))
    rate, sms, clk = issue_rate()
    for name, (n_node, n_leaf, n_slab, n_rest) in counts.items():
        runs = {1: n_node * t4.WARPS, 2: n_slab, 3: n_node * t4.WARPS,
                4: n_leaf * t4.WARPS, 5: n_leaf * t4.WARPS * 8, 6: n_rest}
        instr = sum(runs[k] * size[k] for k in runs)
        log(f"phase 13 T4 {name}: the profiling build issues (a warp) "
            f"{size[1]:.0f} a node entry, {size[2]:.0f} a slab test, "
            f"{size[3]:.0f} a vote and push, {size[4]:.0f} a leaf entry, "
            f"{size[5]:.0f} a triangle to its early exit, {size[6]:.0f} past "
            f"it (its code {len(own)} instructions, the timed build's "
            f"{len(timed)}): {instr / 1e6:.1f}M warp instructions, "
            f"{instr / rate * 1e3:.5f} ms at the full issue rate ({sms} SMs x "
            f"4 x {clk:.0f} MHz) [{card}]")


# the rays of each set on which T3 and T4 are held against their plain
# version: 16 T4 packets, 128 T3 packets from the middle of the set (the
# middle columns of the coherent grid, which hit the scene); the plain walk
# steps once per entry its busiest packet pops, a few ms a step at 2^18 rays
N_PLAIN = 16384
PLAIN_AT = (262144 - N_PLAIN) // 2


def lab_packet_walks(card, tp, cpu_plains, dev="cuda") -> list:
    """T3 and T4 on bench_scene(512, 512) with the tools' two ray sets of
    262,144 rays: each tool's main() with its counter read, then its
    kernel's outputs against the plain version on N_PLAIN rays from the
    middle of the set (t, u, v, slot and visits equal), the packets at
    MAX_VISITS logged; t3_checks and t4_checks (cpu_plains: a future of
    cpu_walk_plains); then B4 (32-ray packets) on the same rays, held
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
    t3_checks(card, t3, scene, rays, dev, cpu_plains)
    t4_checks(card, t4, scene, rays, dev, cpu_plains)
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


def check_dense(tag, pt, td, trace_api, card, launches) -> list:
    """The dense kernel at the cells' shape: the benchmark's Cornell box
    (tests/dense_cases.py:cornell_box, 32 triangles in 88 slots) at
    1024^2, the main path's three wavefronts of 2^20 rays (wavefronts() on
    every primary ray, unsorted, as the path tracer sends them to the
    dense route), each through the kernel and through its plain version on
    the card, in float32 and float64: every output word equal. Both timed;
    the bound is live rays x slots x OPS_TRI operations against 28 bytes in
    and 16 (closest) or 1 (any) out a ray. `launches` are the main path's
    (closest, any) counts. Returns the "kernels" rows of D."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from dense_cases import cornell_box, same_words

    from hydracore_tpu_torch.ops.intersect import ray_args

    dev = torch.device("cuda")
    scene = cornell_box(WIDTH, HEIGHT).to(dev)
    tri9f, slot_tri = scene.wbvh_tri9f, scene.wbvh_slot_tri
    S = slot_tri.shape[0]
    if trace_api._pick(scene) is not td or S != 88:
        raise AssertionError(f"{tag}: {S} slots, route {trace_api._pick(scene)}")
    ray_o, ray_d, _, _ = pt.primary_rays(scene, [0], SEED)
    waves = wavefronts(pt, scene, sort=False, rays=(ray_o, ray_d))
    recs = {f64: {"closest": [], "any": []} for f64 in (False, True)}
    for name, o, d, t_max, act, any_hit in waves:
        R = o.shape[0]
        tm, act_all = ray_args(o, t_max, act)
        live = int(act_all.sum())
        for f64 in (False, True):
            def kernel():
                return td.traverse_dense(tri9f, slot_tri, o, d, t_max, act,
                                         f64=f64, any_hit_mode=any_hit)

            def plain():
                out = td.traverse_dense_plain(tri9f, slot_tri, o, d, tm,
                                              act_all, f64)
                return out[1] >= 0 if any_hit else out

            ms, got = lab.time_ms(kernel, 20, dev, result=True)
            plain_ms, want = lab.time_ms(plain, 3, dev, result=True)
            pairs = [(got, want)] if any_hit else list(zip(got, want))
            if not all(same_words(a, b) for a, b in pairs):
                raise AssertionError(f"{tag} {name} f64={f64}: the kernel's "
                                     "words differ from the plain version's")
            hits = int((want if any_hit else want[1] >= 0).sum())
            if hits == 0:
                raise AssertionError(f"{tag} {name}: no ray hit anything")
            bms, by = lab.bound_ms(R * (28 + (1 if any_hit else 16)),
                                   live * S * OPS_TRI)
            prec = "float64" if f64 else "float32"
            log(f"{tag} {name} {prec}: {R} rays ({live} live, {hits} hits) x "
                f"{S} slots, every word equal to the plain version's; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.5f} ms "
                f"({by}) [{card}]")
            recs[f64]["any" if any_hit else "closest"].append(
                (name, ms, plain_ms, bms, by, 0.0))
    kernels = ("D dense traversal", "D dense traversal")
    return [row for f64 in (False, True) for row in kernel_rows(
        kernels, f"Cornell box 88 slots, {'float64' if f64 else 'float32'}",
        DENSE_CU, "hydracore_tpu/ops/traverse_dense.py:54", recs[f64],
        launches)]


def lab_phases(card, tc, tp) -> list:
    """Phases 12 and 13, the kernel lab, each tool's kernels at its own
    size (tc and tp's libraries built); their "kernels" rows."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        cpu_plains = ex.submit(cpu_walk_plains)
        # ---- phase 12: T7, T6, T5, T1
        t0 = time.time()
        lab_rows = (lab_gather(card) + lab_prims(card) + lab_subvisit(card)
                    + lab_cluster_cost(card, tc))
        if any(r["launches"] <= 0 for r in lab_rows):
            raise AssertionError("phase 12: a lab kernel was not launched by "
                                 "its tool's main()")
        log(f"phase 12 kernel lab: {time.time() - t0:.2f} s")

        # ---- phase 13: the lab's traversal prototypes T2, T3, T4 (and B4
        # on T3's and T4's rays)
        t0 = time.time()
        trav_rows = (lab_proto_cluster(card)
                     + lab_packet_walks(card, tp, cpu_plains))
        if any(r["launches"] <= 0 for r in trav_rows):
            raise AssertionError("phase 13: a lab kernel was not launched by "
                                 "its tool's main()")
        log(f"phase 13 traversal prototypes: {time.time() - t0:.2f} s")
    return lab_rows + trav_rows


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

    def counted(counts, prefix=""):
        return (counts[prefix + "closest_launches"],
                counts[prefix + "any_launches"])

    # ---- phase 1: build every native source, compilers in parallel
    t0 = time.time()
    srcs = ["traverse_cluster.cu", "traverse_packet.cu", "traverse_dense.cu",
            "bvh_builder.cpp", *LAB_SRCS]
    started = {s: build.start_build(s) for s in srcs}
    for s in srcs:
        build.finish_build(s, started[s])
    tc._kernel_lib()
    tp._kernel_lib()
    td._kernel_lib()
    for tool in (t1, t2, t3, t4, t5, t6, t7):
        tool._kernel_lib()
    log(f"phase 1 build: {time.time() - t0:.2f} s ({', '.join(srcs)})")
    if sys.argv[1:] == ["--lab"]:  # phases 12 and 13 alone
        print(json.dumps({"kernels": lab_phases(card, tc, tp)}), flush=True)
        print(card, flush=True)
        return 0

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

    # ---- phase 10: the dense route (its kernel) on a golden recipe, and
    # the kernel against its plain version on the benchmark's Cornell box
    t0 = time.time()
    host_dense = golden_cornell(WIDTH, HEIGHT)
    if trace_api._pick(host_dense) is not td:
        raise AssertionError("auto did not pick the dense route for 12 triangles")
    dense_scene = host_dense.to(dev)
    dense_counts = drive_main_path(
        "phase 10 dense", pt, tc, tp, dense_scene, card,
        {"dense_closest_launches", "dense_any_launches"}, n_pass=1)
    del dense_scene
    dense_rows = check_dense("phase 10 Cornell box", pt, td, trace_api, card,
                             counted(dense_counts, "dense_"))
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

    # ---- phases 12 and 13: the kernel lab
    lab_rows = lab_phases(card, tc, tp)

    # ---- phase 14: textured shading and alpha shadows (B2 over the opaque
    # shadow pool), a scene assembled from a SceneDesc with its files
    t0 = time.time()
    opaque_rows = textured_phase(card, pt, tc, tp, trace_api, dev)
    log(f"phase 14 textured: {time.time() - t0:.2f} s")

    # ---- phase 15: the last gates of the path tracer (SSS, fog, procedural
    # textures with AO probes through B2, render layers)
    t0 = time.time()
    gates_rows = gates_phase(card, pt, tc, tp, trace_api, dev)
    log(f"phase 15 gates: {time.time() - t0:.2f} s")

    # ---- phase 16: the other schedules of the path tracer (the
    # regenerating wavefront, production sampling, render_pass) and a
    # procedural texture compiled from its C source
    t0 = time.time()
    schedule_rows = schedules_phase(card, pt, tc, tp, dev)
    log(f"phase 16 schedules: {time.time() - t0:.2f} s")

    # ---- phase 17: light tracing, the G-buffer and adaptive sampling
    t0 = time.time()
    lt_rows = lt_gbuffer_phase(card, pt, tc, tp, dev, host_inst, desc,
                               host_pkt)
    log(f"phase 17 LT, G-buffer, adaptive: {time.time() - t0:.2f} s")

    # ---- phase 18: bidirectional path tracing (SBDPT and IBPT)
    t0 = time.time()
    bd_rows = bidir_phase(card, pt, tc, tp, dev, host_inst, host_pkt)
    log(f"phase 18 bidirectional: {time.time() - t0:.2f} s")

    # ---- phase 19: Metropolis light transport (PSSMLT and MMLT)
    t0 = time.time()
    mlt_rows = metropolis_phase(card, pt, tc, tp, dev, host_inst, host_pkt)
    log(f"phase 19 Metropolis: {time.time() - t0:.2f} s")

    # ---- phase 20: the front ends (the CLI and its routes, the camera
    # plugin, the viewer), the mesh on NCCL and the utils
    t0 = time.time()
    front_ends_phase(card, pt, tc, tp, dev)
    log(f"phase 20 front ends: {time.time() - t0:.2f} s")
    log(f"all phases: {time.time() - t_start:.1f} s")

    at = "hydracore_tpu/ops/traverse_cluster.py"
    b12 = ("B1 cluster traversal", "B2 cluster traversal")
    b3 = ("B3 cluster traversal", "B3 cluster traversal")
    b4 = ("B4 packet traversal", "B4 packet traversal")

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
            + dense_rows + opaque_rows + gates_rows + schedule_rows + lt_rows
            + bd_rows + mlt_rows + lab_rows)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
