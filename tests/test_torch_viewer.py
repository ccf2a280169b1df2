"""app/viewer.py of the port: the FreeCamera math against the JAX package's
(numpy in both, bit for bit), the session's progressive accumulation and
its reset on a camera or method edit, each method's step against the
port's integrator called directly, and the HTTP surface
(tests/test_viewer.py's cases on the port).

Tolerances: a step renders exactly what the integrator renders for the
same pass, so one step is equal to it; two PT steps are the sum of two
pass images where render_passes sums them in one band, rtol 1e-6.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from hydracore_tpu.app import viewer as jv
from hydracore_tpu_torch.app import viewer as pv
from hydracore_tpu_torch.integrators import bdpt, lt, mlt, pt
from hydracore_tpu_torch.scene.procedural import SceneBuilder
from hydracore_tpu_torch.scene.statefile import CameraDesc
from hydracore_tpu_torch.utils.framebuffer import hdr_to_ldr

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    b = SceneBuilder()
    m = b.add_material(diff_color=np.asarray([0.7, 0.5, 0.3], np.float32))
    b.add_rect([0, -1, 0], [2, 0, 0], [0, 0, 2], m)
    b.add_sphere([0, 0, 0], 0.6, m, n_seg=10, n_ring=6)
    b.sky([0.7, 0.8, 1.0])
    sc = b.build([0, 0.5, 3.0], [0, 0, 0], fov=45.0, width=24, height=18,
                 trace_depth=3)
    desc = CameraDesc(position=np.array([0, 0.5, 3.0], np.float32),
                      look_at=np.zeros(3, np.float32),
                      up=np.array([0, 1, 0], np.float32), fov=45.0)
    return sc, desc


def _session(tiny, **kw):
    sc, desc = tiny
    return pv.InteractiveSession(sc, desc, device="cpu", **kw)


def test_free_camera_bit_equal_to_jax():
    moves = [(10.0, 25.0), (-3.5, 0.0), (0.0, -40.0), (7.25, 12.5)]
    jc = jv.FreeCamera(pos=np.array([0.0, 1.0, -10.0]))
    pc = pv.FreeCamera(pos=np.array([0.0, 1.0, -10.0]))
    for up, right in moves:
        jc.offset_orientation(up, right)
        pc.offset_orientation(up, right)
        jc.offset_position(0.3 * jc.forward() + 0.1 * jc.right())
        pc.offset_position(0.3 * pc.forward() + 0.1 * pc.right())
        for a, b in ((jc.pos, pc.pos), (jc.look_at, pc.look_at),
                     (jc.up, pc.up), (jc.forward(), pc.forward()),
                     (jc.right(), pc.right())):
            assert np.array_equal(a, b)
    f, u = pc.forward(), pc.up
    assert abs(np.dot(f, u)) < 1e-6 and abs(np.linalg.norm(u) - 1) < 1e-6
    assert pv.METHODS == jv.METHODS


def test_accumulates_and_resets_on_camera_move(tiny):
    sc, _ = tiny
    s = _session(tiny, seed=11)
    assert s.step() == 1 and s.step() == 2
    ref, _ = pt.render_passes(sc, 0, 11, n_pass=2, max_depth=3, device="cpu")
    np.testing.assert_allclose(s._fb, ref.numpy(), rtol=1e-6, atol=1e-7)
    img0, spp = s.frame()
    assert spp == 2 and img0.dtype == np.uint8 and img0.shape == (18, 24, 3)
    assert np.array_equal(img0, hdr_to_ldr(s._fb / 2, gamma=s.gamma))
    pos0 = s.cam.pos.copy()
    s.process_input(keys={"w"}, dt=0.3)
    assert np.dot(s.cam.pos - pos0, s.cam.forward()) > 0
    assert s.step() == 1  # reset happened
    img1, spp1 = s.frame()
    assert spp1 == 1 and not np.array_equal(img0, img1)
    assert s.scene.camera.mWorldViewInv.device.type == "cpu"


def test_each_method_steps_as_its_integrator(tiny):
    """One step of each method after a switch is the integrator's first
    pass: lt_pass with W*H paths, bdpt_pass full / 3way, PSSMLT with
    seed + spp and n_passes = max(n_pass, 2)."""
    sc, _ = tiny
    s = _session(tiny, seed=7)
    s.step()
    W, H = 24, 18
    cases = [
        ("lighttracing", lambda: lt.lt_pass(sc, 0, 7, W * H, 3, device="cpu")[0]),
        ("sbdpt", lambda: bdpt.bdpt_pass(sc, 0, 7, 3, "full", device="cpu")),
        ("ibpt", lambda: bdpt.bdpt_pass(sc, 0, 7, 3, "3way", device="cpu")),
        ("pssmlt", lambda: mlt.render_mlt(sc, n_passes=2, seed=7, max_depth=3,
                                          device="cpu")),
    ]
    for method, ref in cases:
        s.set_method(method)
        assert s.step() == 1  # reset + one pass under the new method
        assert s.status()["method"] == method
        assert np.array_equal(s._fb, ref().numpy()), method
    with pytest.raises(ValueError):
        s.set_method("nosuch")


def test_wheel_zoom_clamps_fov(tiny):
    s = _session(tiny)
    s.process_input(wheel=-1000.0)
    assert s.cam.fov == 180.0
    s.process_input(wheel=1e6)
    assert s.cam.fov == 1.0


def test_http_surface(tiny):
    """GET / + /frame.png + /status, POST /input: the full wire protocol."""
    s = _session(tiny, seed=5)
    s.step()
    server = pv.make_server(s, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        html = urllib.request.urlopen(base + "/", timeout=30).read()
        assert b"hydracore_tpu_torch viewer" in html
        png = urllib.request.urlopen(base + "/frame.png", timeout=30).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        st = json.loads(urllib.request.urlopen(base + "/status", timeout=30).read())
        assert st["spp"] == 1 and st["method"] == "pathtracing"
        body = json.dumps({"keys": ["w"], "dt": 0.2}).encode()
        req = urllib.request.Request(base + "/input", data=body, method="POST")
        assert json.loads(urllib.request.urlopen(req, timeout=30).read())["ok"]
        assert s._dirty  # camera moved => next step resets
        body = json.dumps({"method": "sbdpt"}).encode()
        req = urllib.request.Request(base + "/input", data=body, method="POST")
        urllib.request.urlopen(req, timeout=30)
        assert s.status()["method"] == "sbdpt"
        req = urllib.request.Request(base + "/input", data=b'{"method": "x"}',
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)


def test_raytracing_preview_mode(tiny):
    """RENDER_METHOD_RT normals preview: deterministic, never past spp 1."""
    s = _session(tiny)
    s.set_method("raytracing")
    assert s.step() == 1 and s.step() == 1
    img, spp = s.frame()
    assert spp == 1
    c = img[9, 12].astype(np.float64) / 255.0
    assert c[2] > 0.8 and abs(c[0] - 0.5) < 0.2, c
    s.set_method("pathtracing")
    assert s.step() == 1
    assert s.step() == 2


def test_run_viewer_serves_a_library(tmp_path):
    """run_viewer loads a statefile library, renders on its own thread
    and serves the accumulating frame over HTTP."""
    from hydracore_tpu_torch.scene.library import write_library

    write_library(tmp_path, size=8)
    session, server, stop = pv.run_viewer(str(tmp_path), port=0, device="cpu")
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        for _ in range(1200):  # up to a minute on a loaded host
            st = json.loads(urllib.request.urlopen(base + "/status",
                                                   timeout=30).read())
            if st["spp"] >= 2:
                break
            stop.wait(0.05)
        assert st["spp"] >= 2
        png = urllib.request.urlopen(base + "/frame.png", timeout=30).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        stop.set()
        server.shutdown()
        server.server_close()
