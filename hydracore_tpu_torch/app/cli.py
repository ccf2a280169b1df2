"""Command-line renderer: the hydra_app/main.cpp analogue, on the card.

The JAX package's app/cli.py with the same flags, defaults, routes and
printed lines (reference CLI surface hydra_app/input.cpp:167-243):
  -inputlib <dir>   scene library (statefile XML + chunks)
  -out <path>       output PNG
  -statefile <xml>  explicit statefile inside the library
  -spp N | -width/-height | -method X | -seed N | -saveinterval S
  -nowindow 1       headless (0 serves the interactive viewer over HTTP)
  -cl_device_id N   accepted for compatibility, a printed no-op

Usage: python -m hydracore_tpu_torch.app.cli -inputlib <lib> -out z.png
renders on the card; main([...], device="cpu") runs the plain versions of
the kernels on the CPU.

The JAX package's process-wide switches are arguments here: -regen is
render_passes(..., regen=), -double_rt sets settings.double_rt on the
scene (the traversal layer carries the float64 refinement), and there is
no compilation cache to configure. The routes are tried in the JAX
package's order: -method first, then -multichip, then offline_pt, then the
checkpointed pass loop.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hydracore_tpu_torch", add_help=True)
    # single-dash long options, like the reference
    p.add_argument("-inputlib", required=True, help="scene library directory")
    p.add_argument("-out", default="z_out.png")
    p.add_argument("-statefile", default=None)
    p.add_argument("-spp", type=int, default=None)
    p.add_argument("-width", type=int, default=None)
    p.add_argument("-height", type=int, default=None)
    p.add_argument("-method", default=None, help="pathtracing | lt | sbdpt | ibpt | mlt")
    p.add_argument("-seed", type=int, default=None,
                   help="default: statefile <seed> (777)")
    p.add_argument("-saveinterval", type=float, default=0.0, help="seconds between snapshots")
    p.add_argument("-gamma", type=float, default=None,
                   help="default: statefile <outgamma> (2.2)")
    p.add_argument("-offline_pt", type=int, default=None,
                   help="1 = production sampling mode (coherent per-pixel "
                        "blocks, RunProductionSamplingMode analogue)")
    p.add_argument("-multichip", type=int, default=0,
                   help="1 = shard samples over the ranks of a "
                        "torch.distributed group (torchrun), one card each")
    p.add_argument("-evalgbuffer", type=int, default=0)
    p.add_argument("-checkpoint", default=None, help="write resumable state here")
    p.add_argument("-resume", default=None, help="continue from a checkpoint .npz")
    p.add_argument("-stat", type=int, default=0, help="1 = print MRaysStat per-stage timing")
    p.add_argument("-denoise", default=None, choices=[None, "bilateral", "nlm"])
    p.add_argument("-layer", default=None, choices=[None, "color", "direct",
                                                    "indirect"],
                   help="render layer (HRT_DIRECT/INDIRECT_LIGHT_MODE): "
                        "direct + indirect == color")
    p.add_argument("-regen", type=int, default=None,
                   help="1 = regenerating wavefront (full lane utilization)")
    p.add_argument("-maxsamples", type=int, default=None,
                   help="alias of -spp (input.cpp:193-194: 'yes, same')")
    p.add_argument("-enable_mlt", type=int, default=0,
                   help="1 = MLT-at-start: method pathtracing routes to MMLT "
                        "(GPU_MLT_ENABLED_AT_START, RenderDriverRTE.cpp:294)")
    p.add_argument("-mmltthreads", type=int, default=None,
                   help="MMLT chain count (main.cpp:253-260 ladder)")
    p.add_argument("-outdir", default=None, help="directory prefix for -out")
    p.add_argument("-logdir", default=None,
                   help="tee render log into <logdir>/hydra_log.txt")
    p.add_argument("-listdevices", "-list_devices", "-listdev",
                   "-cl_list_devices", dest="listdevices", type=int,
                   default=0, help="1 = print the CUDA devices and exit")
    p.add_argument("-sharedimage", default=None,
                   help="named cross-process shared accumulator: N renderer "
                        "processes (different -seed) add passes into one "
                        "frame (IHRSharedAccumImage role, main.cpp:224-241); "
                        "PT methods only, like the reference")
    p.add_argument("-boxmode", type=int, default=0,
                   help="1 = render standalone even when -sharedimage is "
                        "given (the reference's attach-failure fallback)")
    p.add_argument("-nowindow", type=int, default=1,
                   help="0 = interactive viewer (the reference's GUI window "
                        "mode, main.cpp nowindow flag) served over HTTP")
    p.add_argument("-port", type=int, default=8000, help="viewer HTTP port")
    # compatibility no-ops (OpenCL-runtime and host-thread knobs with no
    # counterpart here) and -double_rt, which sets a scene setting
    p.add_argument("-cl_device_id", type=int, default=0)
    p.add_argument("-cpu_fb", type=int, default=0)
    p.add_argument("-max_cpu_threads", type=int, default=0)
    p.add_argument("-double_rt", type=int, default=0)
    p.add_argument("-alloc_image_b", type=int, default=0)
    p.add_argument("-hydradir", default=None)
    p.add_argument("-outall", default=None)
    return p


class _Tee:
    def __init__(self, *ws):
        self._ws = ws

    def write(self, s):
        for w in self._ws:
            w.write(s)

    def flush(self):
        for w in self._ws:
            w.flush()


def route_of(args, settings) -> str:
    """The route a run takes, in the JAX package's order (cli.py:195-245):
    the method first, then -multichip, then offline_pt, then the pass
    loop. One of raytracing, lt, mmlt, mlt, sbdpt, ibpt, multichip,
    offline_pt, passes."""
    method = (args.method or settings.method or "pathtracing").lower()
    if args.enable_mlt and method in ("pathtracing", "pt"):
        # GPU_MLT_ENABLED_AT_START: pathtracing routes to MMLT
        # (RenderDriverRTE.cpp:294-297)
        method = "mmlt"
    for route, names in (("raytracing", ("raytracing", "rt")),
                         ("lt", ("lighttracing", "lt")),
                         ("mmlt", ("mmlt",)),
                         ("mlt", ("mlt", "pssmlt", "kmlt")),
                         ("sbdpt", ("sbdpt", "bdpt")),
                         ("ibpt", ("ibpt", "3way"))):
        if method in names:
            return route
    if args.multichip:
        return "multichip"
    offline_pt = (args.offline_pt if args.offline_pt is not None
                  else settings.offline_pt)
    return "offline_pt" if offline_pt else "passes"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32)
    return np.asarray(x, np.float32)


def main(argv=None, device=None) -> int:
    """Run the CLI on `device` ("cuda" unless asked). With -logdir, stdout
    is teed into <logdir>/hydra_log.txt and restored on return."""
    args = build_parser().parse_args(argv)
    stdout, log_f = sys.stdout, None
    if args.logdir:  # tee stdout into the log dir (reference -logdir role)
        os.makedirs(args.logdir, exist_ok=True)
        log_f = open(os.path.join(args.logdir, "hydra_log.txt"), "a")
        sys.stdout = _Tee(stdout, log_f)
    try:
        return _run(args, device)
    finally:
        if log_f is not None:
            sys.stdout = stdout
            log_f.close()


def _run(args, device) -> int:
    # compat flags are accepted but have no counterpart: say so instead of
    # silently ignoring them
    for flag in ("cl_device_id", "cpu_fb", "max_cpu_threads",
                 "alloc_image_b"):
        if getattr(args, flag, 0):
            print(f"[config] -{flag} accepted, no-op on the card (OpenCL/host "
                  "knob; the device is the caller's choice, PyTorch owns "
                  "threads and framebuffer placement)")
    regen = bool(args.regen)
    if args.spp is None:
        args.spp = args.maxsamples  # input.cpp:193-194: the same knob
    if args.outdir:
        args.out = os.path.join(args.outdir, args.out)
    if args.listdevices:
        n = torch.cuda.device_count()
        for i in range(n):
            print(f"[device] {i}: cuda {torch.cuda.get_device_name(i)}")
        if n == 0:
            print("[device] no CUDA device (device='cpu' runs the plain "
                  "versions of the kernels)")
        return 0

    if not args.nowindow:  # GUI mode (window_main, main_app_window.cpp:463)
        from hydracore_tpu_torch.app.viewer import run_viewer

        _, server, stop = run_viewer(
            args.inputlib, args.port, args.width, args.height,
            (args.method or "pathtracing"), args.seed or 777, device=device)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            stop.set()
            server.shutdown()
        return 0

    from hydracore_tpu_torch.scene.scene import load_scene
    from hydracore_tpu_torch.utils.device import resolve_device
    from hydracore_tpu_torch.utils.framebuffer import hdr_to_ldr, save_png

    dev = resolve_device(device)
    if args.double_rt:
        # the reference's -D DOUBLE_RAY_TRIANGLE variant
        # (GPUOCLLayer.cpp:695-700): f64 hit refinement
        print("[config] -double_rt: float64 ray/triangle refinement on "
              "(correctness option, reduced rate)")

    t0 = time.time()
    scene = load_scene(args.inputlib, width=args.width, height=args.height,
                       statefile=args.statefile)
    if args.double_rt:
        scene = dataclasses.replace(scene, settings=dataclasses.replace(
            scene.settings, double_rt=True))
    if args.layer and args.layer != "color":
        scene = dataclasses.replace(scene, settings=dataclasses.replace(
            scene.settings, render_layer=args.layer))
    print(f"[scene] {scene.num_triangles} tris, "
          f"{scene.materials.em_color.shape[0]} materials, "
          f"{scene.lights.ltype.shape[0]} lights, "
          f"{scene.camera.width}x{scene.camera.height} "
          f"({time.time() - t0:.1f}s)")

    spp = args.spp or scene.settings.max_rays_per_pixel
    md = scene.settings.trace_depth
    # CLI > statefile > defaults (the reference's 3-tier settings merge)
    if args.seed is None:
        args.seed = scene.settings.seed
    if args.gamma is None:
        args.gamma = scene.settings.out_gamma

    route = route_of(args, scene.settings)
    mesh = None
    if route == "multichip":  # the mesh picks this rank's card
        from hydracore_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(dev)
        dev = mesh.device
    scene = scene.to(dev)  # one upload; every entry point keeps it there
    writer = mesh is None or mesh.rank == 0
    try:
        if route == "raytracing":
            # RENDER_METHOD_RT: primary-rays-only normals preview, the
            # reference's fallback/GUI-default mode (RenderDriverRTE.cpp:309,
            # GPUOCLLayer.cpp:1460 DrawNormals / trace1DPrimaryOnly)
            from hydracore_tpu_torch.integrators.gbuffer import eval_gbuffer

            g = eval_gbuffer(scene, args.seed, device=dev)
            img = _host(g["normal"]) * 0.5 + 0.5
            args.gamma = 1.0
        elif route == "lt":
            from hydracore_tpu_torch.integrators.lt import render_lt

            img = _host(render_lt(scene, n_passes=spp, seed=args.seed,
                                  max_depth=md, device=dev))
        elif route == "mmlt":
            from hydracore_tpu_torch.integrators.mmlt import render_mmlt

            img = _host(render_mmlt(scene, n_passes=max(spp // 4, 8),
                                    seed=args.seed, max_depth=md,
                                    n_chains=args.mmltthreads, device=dev))
        elif route == "mlt":
            from hydracore_tpu_torch.integrators.mlt import render_mlt

            img = _host(render_mlt(scene, n_passes=max(spp // 4, 8),
                                   seed=args.seed, max_depth=md, device=dev))
        elif route == "sbdpt":
            from hydracore_tpu_torch.integrators.bdpt import render_bdpt

            img = _host(render_bdpt(scene, n_passes=spp, seed=args.seed,
                                    max_depth=md, device=dev))
        elif route == "ibpt":
            from hydracore_tpu_torch.integrators.bdpt import render_ibpt

            img = _host(render_ibpt(scene, n_passes=spp, seed=args.seed,
                                    max_depth=md, device=dev))
        elif route == "multichip":
            from hydracore_tpu_torch.parallel.mesh import render_distributed

            print(f"[mesh] {mesh.size} devices")
            img = _host(render_distributed(scene, spp, mesh=mesh,
                                           seed=args.seed))
        elif route == "offline_pt":
            # <offline_pt>1</offline_pt>: production sampling, per-pixel
            # coherent sample blocks (HRT_PRODUCTION_IMAGE_SAMPLING,
            # GPUOCLLayerOther.cpp:502)
            from hydracore_tpu_torch.integrators.pt import render_production

            img = _host(render_production(scene, spp, seed=args.seed,
                                          max_depth=md, device=dev))
        else:
            img = _pass_loop(args, scene, spp, md, dev, regen)
    finally:
        if mesh is not None:
            mesh.close()

    if args.denoise:
        from hydracore_tpu_torch.utils.denoise import bilateral_filter, nlm_filter

        f = bilateral_filter if args.denoise == "bilateral" else nlm_filter
        img = _host(f(torch.as_tensor(img, device=dev)))

    if args.evalgbuffer:
        from hydracore_tpu_torch.integrators.gbuffer import eval_gbuffer

        g = eval_gbuffer(scene, args.seed, device=dev)
        base = args.out.rsplit(".", 1)[0]
        d = _host(g["depth"])
        if writer:
            save_png(base + "_normal.png",
                     hdr_to_ldr(_host(g["normal"]) * 0.5 + 0.5, gamma=1.0))
            save_png(base + "_depth.png",
                     hdr_to_ldr(np.repeat((d / max(d.max(), 1e-6))[..., None],
                                          3, -1), gamma=1.0))
        print(f"[gbuffer] saved {base}_normal.png, {base}_depth.png")

    if writer:
        save_png(args.out, hdr_to_ldr(img, gamma=args.gamma))
    print(f"[done] saved {args.out} in {time.time() - t0:.1f}s")
    return 0


def _pass_loop(args, scene, spp, md, dev, regen) -> np.ndarray:
    """The checkpointed progressive pass loop (cli.py:246-356 of the JAX
    package): chunks of at most 8 passes, snapshots every -saveinterval
    seconds, the exitnow mailbox, the adaptive stop and the shared image.
    Returns the (H, W, 3) mean radiance on the host."""
    from hydracore_tpu_torch.integrators.pt import render_passes
    from hydracore_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
    from hydracore_tpu_torch.utils.framebuffer import hdr_to_ldr, save_png

    H, W = scene.camera.height, scene.camera.width
    fb = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    spp_done = 0
    if args.resume:
        fb_np, spp_done, ck_seed = load_checkpoint(args.resume)
        if fb_np.shape != (H, W, 3):
            raise ValueError(f"checkpoint resolution {fb_np.shape[:2]} is "
                             f"not the scene's {(H, W)}")
        fb = torch.as_tensor(fb_np, device=dev)
        args.seed = ck_seed
        print(f"[resume] {args.resume}: spp={spp_done}")
    t_start = time.time()
    last_save = t_start
    ctl_path = args.out + ".ctl"  # exitnow watchdog mailbox
    shimg = None  # cross-process accumulator (IHRSharedAccumImage role)
    if args.sharedimage and not args.boxmode:
        from hydracore_tpu_torch.utils.shared_image import SharedAccumImage

        shimg = SharedAccumImage.attach_or_create(args.sharedimage, W, H)
        sh_flushed = (np.zeros((H, W, 3), np.float32), spp_done)
        print(f"[sharedimage] attached '{args.sharedimage}' ({W}x{H})")
    # adaptive stop (minRaysPerPixel/pt_error legacy settings,
    # RenderDriverRTE.cpp:324-335): past the spp floor, stop once the
    # frame-to-frame relative change falls below HRT_PATH_TRACE_ERROR
    min_spp = scene.settings.min_rays_per_pixel
    pt_err = scene.settings.pt_error
    err_prev = None  # (fb snapshot, spp) at the last error check
    chunk = max(1, min(8, spp - spp_done))
    i = spp_done
    first = True
    while i < spp:
        k = min(chunk, spp - i)
        color, _ = render_passes(scene, i, args.seed, n_pass=k, max_depth=md,
                                 device=dev, regen=regen)
        fb = fb + color
        i += k
        if first:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            print(f"[compile+pass0] {time.time() - t_start:.1f}s")
            first = False
        now = time.time()
        if args.saveinterval > 0 and now - last_save > args.saveinterval:
            cur = _host(fb)
            save_png(args.out, hdr_to_ldr(cur / i, gamma=args.gamma))
            if args.checkpoint:
                save_checkpoint(args.checkpoint, cur, i, args.seed)
            if shimg is not None:  # flush the delta since the last flush
                shimg.add(cur - sh_flushed[0], i - sh_flushed[1])
                sh_flushed = (cur, i)
            last_save = now
        # exitnow IPC: a control file OR the shared image's message channel
        # ends the loop gracefully (the reference's shared-memory message
        # channel / max-spp watchdog, main_app_console.cpp:84,
        # RenderDriverRTE.cpp:1921)
        stop_msg = False
        if os.path.exists(ctl_path):
            with open(ctl_path) as f:
                stop_msg = "exitnow" in f.read()
        if not stop_msg and shimg is not None:
            stop_msg = "exitnow" in shimg.recv_message()
        if stop_msg:
            print(f"[exitnow] stopping at spp={i}")
            if os.path.exists(ctl_path):
                os.remove(ctl_path)
            spp = i
            break
        if min_spp > 0 and i >= min_spp and (i % 32 == 0 or i >= spp):
            cur = _host(fb) / i
            if err_prev is not None:
                prev_fb, prev_i = err_prev
                lum = cur.mean(axis=-1)
                dl = np.abs(lum - (prev_fb / prev_i).mean(axis=-1))
                err = float(dl.mean() / max(lum.mean(), 1e-6))
                if err < pt_err:
                    print(f"[adaptive] stop at spp={i}: err {err:.4f} "
                          f"< pt_error {pt_err:.4f}")
                    spp = i
            err_prev = (_host(fb), i)
        if i % 16 == 0 or i >= spp:
            el = now - t_start
            msps = (i - spp_done) * W * H / max(el, 1e-9) / 1e6
            print(f"[pass] spp = {i}/{spp}, speed = {msps:.2f} M(samples)/s",
                  flush=True)
    fb = _host(fb)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, fb, spp, args.seed)
    img = fb / max(spp, 1)
    if shimg is not None:
        # final flush, then the COMBINED frame (every attached process
        # converges to the same merged image, so whichever finishes last
        # leaves the complete result: the master-merge role of the
        # reference's external image)
        shimg.add(fb - sh_flushed[0], spp - sh_flushed[1])
        comb, comb_spp = shimg.read()
        print(f"[sharedimage] combined spp = {comb_spp:.0f}")
        img = comb / max(comb_spp, 1)
        shimg.close()

    if args.stat:
        from hydracore_tpu_torch.utils.stats import profile_pass

        print(profile_pass(scene, max_depth=md, device=dev).summary())
    return img


if __name__ == "__main__":
    sys.exit(main())
