"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's native code from the checkout (csrc/ -> the git-ignored
hydracore_tpu_torch/_build/, the compilers started together), then drives
four main paths of the MIS+NEE path tracer, render_passes at 1024x1024,
depth 5, seed 777, each through its kernels:
  flat         the procedural bench_scene (26,252 triangles, one flat
               cluster pool) through B1 (closest hit) and B2 (any hit);
  instanced    a cornell box holding 24 transformed instances of one
               25,280-triangle mesh, assembled from a SceneDesc with
               instancing="auto" (over 400,000 flattened triangles), through
               B3 in both hit modes;
  partitioned  bench_scene with its large sphere at 201,600 triangles (a
               pool of three 1024-cluster chunks) through the chunk loop of
               B1 and B2;
  packet       the same 202,572 triangles built with traversal="packet":
               warp packets over the 8-wide BVH through B4 in both hit
               modes, the wavefronts unsorted as that route leaves them.
For each path it first holds the kernels against their plain PyTorch twin
on the card at the path's shapes (primary, bounce and shadow wavefronts of
2^18 rays) and times both, then resets the launch counters, renders, and
checks the counters (and, for B4, that no packet reached MAX_VISITS). The
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
Any failed check raises: the script then exits non-zero and prints no
result line. On success the last line is the JSON result
{"ok": true, "device": {...}}; the line before it the card's name and power
limit; before that a "kernels" JSON line.
"""
from __future__ import annotations

import json
import os
import sys
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


def needed_visits(scene, rays, t_end) -> tuple[int, int]:
    """(active rays, ray-cluster pairs whose box a ray enters before its
    final t): the box tests and Woop blocks this run's data needs,
    whatever walks them."""
    from hydracore_tpu_torch.ops.intersect import safe_inv
    from hydracore_tpu_torch.ops.traverse_cluster import BIG

    flat = rays.reshape(-1, 8)
    act = flat[:, 7] > 0
    b = real_boxes(scene)
    n_act = int(act.sum())
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
        visits += int(hit.sum())
    return n_act, visits


def cluster_bound_ms(scene, rays, t_end) -> tuple[float, str]:
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
    return lab.bound_ms(bytes_, ops)


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


def wavefronts(pt, scene, sort: bool = True):
    """The main path's three kinds of wavefront on `scene`, 2^18 rays each:
    every 4th primary ray of the frame in Morton order (spread over the
    whole image), cosine-sampled bounce rays off their hit points and
    shadow rays to uniform points on the rect light (light row 0). With
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
    lp = (lt.pos[0] + (2 * rnd[:, 2:3] - 1) * lt.vx[0]
          + (2 * rnd[:, 3:4] - 1) * lt.vy[0])
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
        ms = lab.time_ms(lambda: tc.cluster_traverse(
            rays, any_hit_mode=any_hit_mode, **pool), 20, rays.device)
        plain = lab.time_ms(lambda: tc.cluster_traverse_plain(
            rays, any_hit_mode=any_hit_mode, **pool), 1, rays.device)
        bms, by = cluster_bound_ms(scene, rays, tk.reshape(-1))
        log(f"{tag} {name}: kernel {ms:.4f} ms, twin {plain:.4f} ms, "
            f"bound {bms:.5f} ms ({by}) [{card}]")
        out["any" if any_hit_mode else "closest"].append(
            (name, ms, plain, bms, by, err))
    return out


COUNTERS = ("closest_launches", "any_launches", "inst_closest_launches",
            "inst_any_launches", "pkt_closest_launches", "pkt_any_launches")


def launch_counts(tc, tp) -> dict:
    """Every wrapper's launch count: B1, B2, B3 (closest, any), B4 (closest,
    any)."""
    out = {k: getattr(tc, k) for k in COUNTERS[:4]}
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


def card_vs_cpu(tag, pt, small, spp: int = 8) -> torch.Tensor:
    """64x64, `spp` samples on the card against the CPU (the kernels'
    twins, or the same plain code): >= 99% of pixels within 1e-3. Returns
    the card's image."""
    img_gpu = pt.render(small, spp=spp, seed=SEED, device="cuda").cpu()
    img_cpu = pt.render(small, spp=spp, seed=SEED, device="cpu")
    close = pixels_close(img_gpu, img_cpu)
    log(f"{tag} 64x64 {spp} spp: pixels within 1e-3 of the CPU's image: "
        f"{close:.4f}")
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
            tk, sk = tc.cluster_traverse(rays, *pool)
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
    flat_recs = check_kernels("phase 3 flat", tc, scene,
                              cluster_cases(tc, wavefronts(pt, scene)), card)
    log(f"phase 4 flat: {N_PASS} passes (4 before the instanced and "
        "partitioned paths joined the run)")
    flat_counts = drive_main_path("phase 4 flat", pt, tc, tp, scene, card,
                                  {"closest_launches", "any_launches"})
    img_flat_cluster = card_vs_cpu("phase 4 flat", pt,
                                   bench_scene(64, 64, DEPTH))
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
                              cluster_cases(tc, wavefronts(pt, inst_scene)),
                              card)
    inst_counts = drive_main_path(
        "phase 6 instanced", pt, tc, tp, inst_scene, card,
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
    part_raw = wavefronts(pt, part_scene)
    part_recs = check_kernels("phase 7 partitioned", tc, part_scene,
                              cluster_cases(tc, part_raw), card,
                              flat_scene=repacked)
    del repacked
    part_counts = drive_main_path("phase 7 partitioned", pt, tc, tp,
                                  part_scene, card,
                                  {"closest_launches", "any_launches"})
    profile_pass(pt, part_scene, card, "phase 7 partitioned")

    # ---- phase 8: the packet route (B4) on the partitioned phase's geometry
    t0 = time.time()
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
    pkt_recs = check_packet("phase 8 packet", tp, pkt_scene,
                            wavefronts(pt, pkt_scene, sort=False), card)
    # and B4 on the very rays the chunked B1/B2 got in phase 7 (sorted)
    srt_recs = check_packet("phase 8 packet, sorted rays", tp, pkt_scene,
                            part_raw, card, twin=False)
    for (name, o, d, t_max, act, any_hit), (_, blocks, _) in zip(
            part_raw, cluster_cases(tc, part_raw)):
        _, s_cl = tc.cluster_traverse(blocks, any_hit_mode=any_hit,
                                      **scene_pool(part_scene))
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

    # ---- phase 9: the wide-BVH loop (plain PyTorch) on the same geometry,
    # 256x256, one pass; 64x64 card against CPU
    t0 = time.time()
    host_wide = bench_scene(256, 256, DEPTH, builder=big, traversal="wide")
    wide_scene = host_wide.to(dev)
    drive_main_path("phase 9 wide", pt, tc, tp, wide_scene, card, set(),
                    width=256, height=256, n_pass=1)
    del wide_scene
    card_vs_cpu("phase 9 wide", pt,
                bench_scene(64, 64, DEPTH, builder=big, traversal="wide"), spp=2)
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
    img_flat_packet = card_vs_cpu(
        "phase 11 packet", pt, bench_scene(64, 64, DEPTH, traversal="packet"))
    close = pixels_close(img_flat_packet, img_flat_cluster)
    log(f"phase 11 packet 64x64 8 spp: pixels within 1e-3 of the cluster "
        f"route's image: {close:.4f}")
    if close < 0.99:
        raise AssertionError(f"packet vs cluster route image: {close}")

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
            + lab_rows + trav_rows)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
