"""Multi-device rendering: the sample stream sharded over a process group.

The JAX package's parallel/mesh.py shards each pass over a 1-D
jax.sharding.Mesh and combines the framebuffer with XLA collectives. Here a
"mesh" is a torch.distributed process group, one process a card (NCCL), or
one process a CPU rank (gloo): the scene is replicated on every rank, each
rank traces its share, and the framebuffer is combined with all_reduce or
all_gather. The reference's own multi-GPU scheme is one process per GPU
adding into a shared accumulator image (utils/shared_image.py).

Two sharding modes, both exact:
  * pixel-sharded: each rank owns a contiguous strip of pixels per pass;
    the strips come back through all_gather in rank order;
  * sample-sharded: each rank renders ALL pixels with its own QMC pass
    offset (qmcPos = pass * n + rank, SURVEY.md §5 'distributed
    communication backend'); the framebuffers are summed with all_reduce
    and divided by n.

make_mesh joins a process group that is already initialised (torchrun's
env:// rendezvous, or one the caller set up), else makes a world of 1 in
this process. It uses NCCL on the card and gloo on the CPU and never falls
back from one to the other.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from hydracore_tpu_torch.integrators.pt import (DG_LENS, MEGABLOCK,
                                                make_eye_rays, pt_trace)
from hydracore_tpu_torch.ops import rng
from hydracore_tpu_torch.scene.scene import check_supported
from hydracore_tpu_torch.utils.device import resolve_device

_ENV_RENDEZVOUS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@dataclass
class Mesh:
    """A process group with this process's rank in it and its device."""

    group: object
    rank: int
    size: int
    device: torch.device
    owned: bool = False  # this object initialised the default group

    def close(self) -> None:
        """Destroy the default group if make_mesh created it."""
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
        self.owned = False


def make_mesh(device=None) -> Mesh:
    """The mesh of every rank of the default process group on `device`
    ("cuda" unless asked: NCCL; "cpu": gloo). Joins the default group if it
    is initialised, else runs torchrun's env:// rendezvous when its
    variables are set, else makes a world of 1 in this process."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    owned = False
    if not dist.is_initialized():
        if all(k in os.environ for k in _ENV_RENDEZVOUS):
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        owned = True
    have = dist.get_backend()
    if have != backend:
        raise RuntimeError(f"the process group runs {have!r}, a mesh on "
                           f"{dev.type} needs {backend!r}")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(),
                size=dist.get_world_size(), device=dev, owned=owned)


def _trace_pixels(scene, pix, pass_idx: int, seed: int, max_depth: int):
    """One sample for each flat pixel id of pix (R,) int64 at QMC pass
    pass_idx, in wavefronts of at most MEGABLOCK rays: (colors (R, 3)
    clipped to [0, 1e6], rays traced)."""
    W = scene.camera.width
    p = pass_idx & rng.M32
    colors, rays = [], 0
    for s in range(0, pix.shape[0], MEGABLOCK):
        px = pix[s:s + MEGABLOCK]
        sample_idx = rng.mul32(px, 0x9E3779B9) ^ p
        jitter = rng.screen_sample(torch.full_like(px, p), px)
        lens = rng.rand2(sample_idx, 0, DG_LENS, seed)
        ray_o, ray_d = make_eye_rays(scene.camera, px % W, px // W, jitter,
                                     lens)
        c, r = pt_trace(scene, ray_o, ray_d, sample_idx, seed,
                        max_depth=max_depth)
        colors.append(torch.clamp(c, 0.0, 1e6))
        rays = rays + r
    return torch.cat(colors), rays


def place(scene, mesh: Mesh):
    """The scene checked (scene.check_supported) and on the mesh's
    device, as the per-pass functions below take it."""
    check_supported(scene)
    return scene.to(mesh.device)


def render_pass_sample_sharded(scene, pass_idx: int, seed: int, mesh: Mesh,
                               max_depth: int = 5):
    """Each rank renders every pixel at pass pass_idx * n + rank; returns
    the all_reduce-averaged framebuffer (H, W, 3) and the rays of all ranks
    (n samples a pixel a call), the same on every rank. `scene` is placed
    (place(scene, mesh))."""
    W, H = scene.camera.width, scene.camera.height
    n = mesh.size
    pix = torch.arange(W * H, dtype=torch.int64, device=mesh.device)
    color, rays = _trace_pixels(scene, pix, pass_idx * n + mesh.rank, seed,
                                max_depth)
    fb = color.reshape(H, W, 3).contiguous()
    dist.all_reduce(fb, group=mesh.group)
    rays = torch.as_tensor(rays, dtype=torch.int64, device=mesh.device).clone()
    dist.all_reduce(rays, group=mesh.group)
    return fb / n, rays


def render_pass_pixel_sharded(scene, pass_idx: int, seed: int, mesh: Mesh,
                              max_depth: int = 5):
    """Pixels in contiguous strips, rank r the r-th of n; one sample a
    pixel a call. Returns the (H, W, 3) frame (the strips all_gathered in
    rank order) and the rays of all ranks, the same on every rank. `scene`
    is placed (place(scene, mesh))."""
    W, H = scene.camera.width, scene.camera.height
    n = mesh.size
    if (W * H) % n:
        raise ValueError(f"{W * H} pixels do not divide over {n} ranks")
    pix = torch.arange(W * H, dtype=torch.int64,
                       device=mesh.device).reshape(n, -1)[mesh.rank]
    color, rays = _trace_pixels(scene, pix, pass_idx, seed, max_depth)
    strips = [torch.empty_like(color) for _ in range(n)]
    dist.all_gather(strips, color.contiguous(), group=mesh.group)
    rays = torch.as_tensor(rays, dtype=torch.int64, device=mesh.device).clone()
    dist.all_reduce(rays, group=mesh.group)
    return torch.cat(strips).reshape(H, W, 3), rays


def render_distributed(scene, spp: int, mesh: Mesh | None = None,
                       seed: int = 777, max_depth: int | None = None,
                       mode: str = "sample", device=None):
    """Host pass loop over the mesh (made, and closed after, when none is
    given); returns the (H, W, 3) mean radiance on the mesh's device. The
    sample mode makes max(spp // n, 1) calls of n samples a pixel, as the
    JAX package does."""
    own = mesh is None
    mesh = mesh or make_mesh(device)
    try:
        md = max_depth or scene.settings.trace_depth
        scene = place(scene, mesh)
        H, W = scene.camera.height, scene.camera.width
        fb = torch.zeros((H, W, 3), dtype=torch.float32, device=mesh.device)
        if mode == "sample":
            n_calls = max(spp // mesh.size, 1)
            for i in range(n_calls):
                color, _ = render_pass_sample_sharded(scene, i, seed, mesh, md)
                fb = fb + color
            return fb / n_calls
        for i in range(spp):
            color, _ = render_pass_pixel_sharded(scene, i, seed, mesh, md)
            fb = fb + color
        return fb / spp
    finally:
        if own:
            mesh.close()


def render_lt_pass_sharded(scene, pass_idx: int, seed: int, mesh: Mesh,
                           n_paths: int, max_depth: int = 5):
    """Distributed light tracing: each rank traces its own light-path
    stream (pass offset pass * n + rank, the PT path's stream-sharding
    rule) and splats locally; the framebuffers are all_reduce-averaged.
    Returns (image, paths of all ranks). `scene` is placed (place(scene,
    mesh))."""
    from hydracore_tpu_torch.integrators.lt import lt_pass

    n = mesh.size
    img, paths = lt_pass(scene, ((pass_idx * n + mesh.rank) & rng.M32), seed,
                         n_paths, max_depth=max_depth, device=mesh.device)
    img = img.contiguous()
    dist.all_reduce(img, group=mesh.group)
    return img / n, paths * n


def render_lt_distributed(scene, n_passes: int, mesh: Mesh | None = None,
                          seed: int = 777, paths_per_pass: int | None = None,
                          max_depth: int | None = None, device=None):
    """(H, W, 3) LT estimate from max(n_passes // n, 1) calls of n
    light-path streams."""
    own = mesh is None
    mesh = mesh or make_mesh(device)
    try:
        md = max_depth or scene.settings.trace_depth
        scene = place(scene, mesh)
        H, W = scene.camera.height, scene.camera.width
        n_paths = paths_per_pass or (W * H)
        n_calls = max(n_passes // mesh.size, 1)
        fb = torch.zeros((H, W, 3), dtype=torch.float32, device=mesh.device)
        for i in range(n_calls):
            img, _ = render_lt_pass_sharded(scene, i, seed, mesh, n_paths, md)
            fb = fb + img
        return fb / n_calls
    finally:
        if own:
            mesh.close()
