"""Interactive progressive render loop: the GUI window loop, served over HTTP.

The JAX package's app/viewer.py on the port. The reference's GUI
(hydra_app/main_app_window.cpp:463-528) is a glfw/OpenGL window around
three behaviors: a free camera driven by WASD+RF keys, mouse-drag
orientation and wheel fov zoom (Update(), main_app_window.cpp:137-180,
Camera.h); a per-frame write of the camera + render method back into the
render settings, after which the driver keeps ACCUMULATING until something
changed, in which case accumulation restarts (Draw(), main_app_window.cpp:
181-290); and method hotkeys switching pathtracing / lighttracing / SBDPT /
IBPT / MMLT live (key(), main_app_window.cpp:306-400).

The interactive surface is an HTTP endpoint: the render loop runs on the
card (a worker thread, so every render call names the session's device),
the browser polls `/frame.png` (the tonemapped accumulator, GetLDRImage
semantics) and posts key/mouse input to `/input`. `InteractiveSession` is
the loop itself (camera, accumulator, method switching) with no server
attached, so all of it is testable headless.

Start it with:
    python -m hydracore_tpu_torch.app.viewer -inputlib <scene_lib> -port 8000
"""
from __future__ import annotations

import dataclasses
import io
import json
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

_TORAD = 0.01745329251994329576923690768489


@dataclass
class FreeCamera:
    """Mirror of hydra_app/Camera.h: a lookAt camera moved by world-space
    offsets and rotated about its own right axis (vertical) / world Y
    (horizontal)."""

    pos: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, -10.0]))
    look_at: np.ndarray = field(default_factory=lambda: np.zeros(3))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    fov: float = 45.0
    tdist: float = 100.0

    def forward(self) -> np.ndarray:
        f = self.look_at - self.pos
        return f / max(np.linalg.norm(f), 1e-12)

    def right(self) -> np.ndarray:
        r = np.cross(self.forward(), self.up)
        return r / max(np.linalg.norm(r), 1e-12)

    def offset_position(self, off: np.ndarray) -> None:
        self.pos = self.pos + off
        self.look_at = self.look_at + off

    def offset_orientation(self, up_angle: float, right_angle: float) -> None:
        """Camera.h offsetOrientation: vertical tilt re-orthogonalizes `up`
        from the right axis; horizontal is a rotation about world Y."""
        if up_angle != 0.0:
            c, s = np.cos(-_TORAD * up_angle), np.sin(-_TORAD * up_angle)
            d = self.forward() * c + self.up * s
            d = d / max(np.linalg.norm(d), 1e-12)
            u = np.cross(self.right(), d)
            self.up = u / max(np.linalg.norm(u), 1e-12)
            self.look_at = self.pos + self.tdist * d
        if right_angle != 0.0:
            c, s = np.cos(-_TORAD * right_angle), np.sin(-_TORAD * right_angle)
            rot = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
            d = rot @ self.forward()
            d = d / max(np.linalg.norm(d), 1e-12)
            u = rot @ self.up
            self.up = u / max(np.linalg.norm(u), 1e-12)
            self.look_at = self.pos + self.tdist * d


# method hotkeys (main_app_window.cpp:306-400: P/L/B/I/M + production toggle;
# "raytracing" is the reference's RENDER_METHOD_RT normals preview —
# DrawNormals, GPUOCLLayer.cpp:1460 — and its GUI default)
METHODS = ("pathtracing", "lighttracing", "sbdpt", "ibpt", "mmlt", "pssmlt",
           "raytracing")


class InteractiveSession:
    """The render loop behind the viewer: progressive accumulation with
    camera/method edits resetting it (hrCommit-restarts-accumulation
    semantics, Draw() main_app_window.cpp:181-290). Thread-safe: `step()`
    may run on a worker thread while input arrives on another. Renders on
    `device` ("cuda" unless asked); `regen` reaches every path-tracing
    step's render_passes (the JAX package's process-wide HYDRA_REGEN=1)."""

    def __init__(self, scene, cam_desc, method: str = "pathtracing",
                 seed: int = 777, max_depth: int | None = None,
                 move_speed: float = 2.5, mouse_sens: float = 0.1,
                 device=None, regen: bool = False):
        from hydracore_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.scene = scene.to(self.device)
        self.cam_desc = cam_desc
        self.cam = FreeCamera(
            pos=np.asarray(cam_desc.position, np.float64).copy(),
            look_at=np.asarray(cam_desc.look_at, np.float64).copy(),
            up=np.asarray(cam_desc.up, np.float64).copy(),
            fov=float(cam_desc.fov))
        self.method = method
        self.regen = bool(regen)
        self.seed = int(seed)
        self.max_depth = int(max_depth or scene.settings.trace_depth)
        self.move_speed = move_speed  # g_input.camMoveSpeed
        self.mouse_sens = mouse_sens  # g_input.mouseSensitivity
        self.gamma = float(getattr(scene.settings, "out_gamma", 2.2) or 2.2)
        H, W = scene.camera.height, scene.camera.width
        self._fb = np.zeros((H, W, 3), np.float32)
        self._spp = 0
        self._dirty = False
        self._lock = threading.Lock()
        self._msps = 0.0

    # ---- input (Update(), main_app_window.cpp:137-180) ----
    def process_input(self, keys=(), dt: float = 1.0 / 60.0,
                      mouse=(0.0, 0.0), wheel: float = 0.0) -> None:
        with self._lock:
            cam, moved = self.cam, False
            step = dt * self.move_speed
            if "s" in keys:
                cam.offset_position(-step * cam.forward()); moved = True
            elif "w" in keys:
                cam.offset_position(step * cam.forward()); moved = True
            if "a" in keys:
                cam.offset_position(-step * cam.right()); moved = True
            elif "d" in keys:
                cam.offset_position(step * cam.right()); moved = True
            if "f" in keys:
                cam.offset_position(-step * cam.up); moved = True
            elif "r" in keys:
                cam.offset_position(step * cam.up); moved = True
            mx, my = float(mouse[0]), float(mouse[1])
            if mx != 0.0 or my != 0.0:
                cam.offset_orientation(self.mouse_sens * my,
                                       -self.mouse_sens * mx)
                moved = True
            if wheel != 0.0:  # zoomSensitivity fov clamp, Update():172-178
                cam.fov = float(np.clip(cam.fov - 0.2 * wheel, 1.0, 180.0))
                moved = True
            if moved:
                self._dirty = True

    def set_method(self, method: str) -> None:
        method = method.lower()
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r} (one of {METHODS})")
        with self._lock:
            if method != self.method:
                self.method = method
                self._dirty = True

    # ---- the loop body (Draw() semantics) ----
    def _rebuild_camera(self) -> None:
        from hydracore_tpu_torch.scene.camera import build_camera

        desc = dataclasses.replace(
            self.cam_desc,
            position=self.cam.pos.astype(np.float32),
            look_at=self.cam.look_at.astype(np.float32),
            up=self.cam.up.astype(np.float32),
            fov=float(self.cam.fov))
        cam = build_camera(desc, self.scene.camera.width,
                           self.scene.camera.height)
        self.scene = dataclasses.replace(self.scene,
                                         camera=cam.to(self.device))

    def step(self, n_pass: int = 1) -> int:
        """Render `n_pass` progressive passes with the current camera and
        method; returns the new spp. A camera/method edit since the last
        step resets accumulation first."""
        with self._lock:
            if self._dirty:
                self._rebuild_camera()
                self._fb[:] = 0.0
                self._spp = 0
                self._dirty = False
            scene, method, spp = self.scene, self.method, self._spp
        dev = self.device
        t0 = time.time()
        if method == "raytracing":
            # primary-only normals preview: one deterministic eval, no
            # progressive accumulation (the reference redraws per frame)
            from hydracore_tpu_torch.integrators.gbuffer import eval_gbuffer

            g = eval_gbuffer(scene, self.seed, device=dev)
            view = g["normal"].cpu().numpy().astype(np.float32) * 0.5 + 0.5
            # store gamma-compensated so frame()'s tonemap returns it raw
            view = np.power(np.clip(view, 0.0, 1.0), self.gamma)
            with self._lock:
                if not self._dirty:
                    self._fb[:] = view
                    self._spp = 1
            time.sleep(0.1)  # static view: don't spin the render loop
            return self._spp
        if method == "pathtracing":
            from hydracore_tpu_torch.integrators.pt import render_passes

            img, _ = render_passes(scene, spp, self.seed, n_pass=n_pass,
                                   max_depth=self.max_depth, device=dev,
                                   regen=self.regen)
        elif method == "lighttracing":
            from hydracore_tpu_torch.integrators.lt import lt_pass

            H, W = self._fb.shape[0], self._fb.shape[1]
            img = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
            for i in range(n_pass):
                p, _ = lt_pass(scene, spp + i, self.seed, W * H,
                               max_depth=self.max_depth, device=dev)
                img = img + p
        elif method in ("sbdpt", "ibpt"):
            from hydracore_tpu_torch.integrators.bdpt import bdpt_pass

            strat = "full" if method == "sbdpt" else "3way"
            img = torch.zeros(self._fb.shape, dtype=torch.float32, device=dev)
            for i in range(n_pass):
                img = img + bdpt_pass(scene, spp + i, self.seed,
                                      max_depth=self.max_depth,
                                      strategies=strat, device=dev)
        else:  # mmlt / pssmlt: each step is a small self-contained chunk
            # (burn-in per chunk; the reference pays the same restart when
            # the camera moves, GPUOCLLayerAdvanced.cpp burn-in path)
            from hydracore_tpu_torch.integrators.mlt import render_mlt
            from hydracore_tpu_torch.integrators.mmlt import render_mmlt

            f = render_mmlt if method == "mmlt" else render_mlt
            img = f(scene, n_passes=max(n_pass, 2), seed=self.seed + spp,
                    max_depth=self.max_depth, device=dev) * n_pass
        img = img.cpu().numpy().astype(np.float32)
        with self._lock:
            if self._dirty:  # input raced the render: drop the stale passes
                return self._spp
            self._fb += img
            self._spp += n_pass
            el = max(time.time() - t0, 1e-9)
            self._msps = n_pass * self._fb.shape[0] * self._fb.shape[1] / el / 1e6
            return self._spp

    # ---- readback (GetLDRImage semantics) ----
    def frame(self):
        """(H, W, 3) uint8 tonemapped current accumulation + spp."""
        from hydracore_tpu_torch.utils.framebuffer import hdr_to_ldr

        with self._lock:
            fb, spp = self._fb.copy(), self._spp
        return hdr_to_ldr(fb / max(spp, 1), gamma=self.gamma), spp

    def status(self) -> dict:
        with self._lock:
            return {"spp": self._spp, "method": self.method,
                    "msamples_per_s": round(self._msps, 4),
                    "fov": round(self.cam.fov, 3),
                    "pos": [round(float(x), 4) for x in self.cam.pos]}


_PAGE = """<!doctype html><title>hydracore_tpu_torch viewer</title>
<style>body{background:#111;color:#ccc;font-family:monospace;text-align:center}
img{image-rendering:pixelated;width:70vmin}</style>
<h3 id=s>connecting…</h3><img id=v><p>WASD move · R/F up/down · drag look ·
wheel zoom · P/L/B/I/M method · N normals preview</p>
<script>
const keys=new Set(),km={p:'pathtracing',l:'lighttracing',b:'sbdpt',i:'ibpt',m:'mmlt',n:'raytracing'};
let drag=null;
onkeydown=e=>{const k=e.key.toLowerCase();
  if(km[k])fetch('/input',{method:'POST',body:JSON.stringify({method:km[k]})});
  else keys.add(k)};
onkeyup=e=>keys.delete(e.key.toLowerCase());
v.onmousedown=e=>drag=[e.clientX,e.clientY];
onmouseup=()=>drag=null;
onmousemove=e=>{if(drag){post({mouse:[e.clientX-drag[0],e.clientY-drag[1]]});
  drag=[e.clientX,e.clientY]}};
onwheel=e=>post({wheel:e.deltaY>0?-1:1});
function post(x){fetch('/input',{method:'POST',body:JSON.stringify(x)})}
setInterval(()=>{if(keys.size)post({keys:[...keys],dt:0.1})},100);
setInterval(()=>{v.src='/frame.png?t='+Date.now();
  fetch('/status').then(r=>r.json()).then(j=>
    s.textContent=`${j.method}  spp=${j.spp}  ${j.msamples_per_s} Msamples/s`)},700);
</script>"""


def make_server(session: InteractiveSession, port: int = 0):
    """HTTP front-end over an InteractiveSession. Returns the (not yet
    started) ThreadingHTTPServer; `server.server_address[1]` is the bound
    port (port=0 picks a free one — used by the tests)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif path == "/frame.png":
                from PIL import Image

                img, spp = session.frame()
                buf = io.BytesIO()
                Image.fromarray(img, "RGB").save(buf, "PNG")
                self._send(200, "image/png", buf.getvalue())
            elif path == "/status":
                self._send(200, "application/json",
                           json.dumps(session.status()).encode())
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if self.path.split("?")[0] != "/input":
                self._send(404, "text/plain", b"not found")
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                msg = json.loads(self.rfile.read(n) or b"{}")
                if "method" in msg:
                    session.set_method(msg["method"])
                session.process_input(
                    keys=set(msg.get("keys", ())),
                    dt=float(msg.get("dt", 1.0 / 60.0)),
                    mouse=msg.get("mouse", (0.0, 0.0)),
                    wheel=float(msg.get("wheel", 0.0)))
                self._send(200, "application/json", b"{\"ok\":true}")
            except (ValueError, KeyError) as e:
                self._send(400, "text/plain", str(e).encode())

        def log_message(self, *a):  # quiet
            pass

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def run_viewer(inputlib: str, port: int = 8000, width=None, height=None,
               method: str = "pathtracing", seed: int = 777,
               stop_event: threading.Event | None = None, device=None,
               regen: bool = False):
    """Load the scene, start the render thread + HTTP server (the reference's
    window_main, main_app_window.cpp:463). Returns (session, server, stop):
    set `stop` and shut the server down to end both threads."""
    from hydracore_tpu_torch.scene.scene import assemble
    from hydracore_tpu_torch.scene.statefile import load_statefile

    desc = load_statefile(inputlib)
    scene = assemble(desc, width, height)
    session = InteractiveSession(scene, desc.camera, method=method, seed=seed,
                                 device=device, regen=regen)
    server = make_server(session, port)
    stop = stop_event or threading.Event()

    def loop():
        while not stop.is_set():
            try:
                session.step(1)
            except Exception as e:  # keep serving the last good frame
                print(f"[viewer] render step failed: {e!r}", flush=True)
                stop.wait(1.0)

    rt = threading.Thread(target=loop, daemon=True)
    st = threading.Thread(target=server.serve_forever, daemon=True)
    rt.start()
    st.start()
    print(f"[viewer] http://127.0.0.1:{server.server_address[1]}/ "
          f"({scene.camera.width}x{scene.camera.height}, {method})", flush=True)
    return session, server, stop


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="interactive progressive viewer")
    p.add_argument("-inputlib", required=True)
    p.add_argument("-port", type=int, default=8000)
    p.add_argument("-width", type=int, default=None)
    p.add_argument("-height", type=int, default=None)
    p.add_argument("-method", default="pathtracing")
    p.add_argument("-seed", type=int, default=777)
    a = p.parse_args(argv)
    _, server, stop = run_viewer(a.inputlib, a.port, a.width, a.height,
                                 a.method, a.seed)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        stop.set()
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
