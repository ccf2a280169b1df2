"""app/cli.py of the port on the CPU (main([...], device="cpu")): the
parser against the JAX package's, the order of the routes, each route's
image against the port's integrator called directly, the pass loop's
checkpoint, resume, exitnow, adaptive stop and shared image, -logdir
restoring stdout, and two CLI processes merging into one shared image.

Scenes are scene/library.py:write_library's 8x8 library
(trace depth 4, seed 5, clamping 100), with a setting or two added where
a case needs it.

Tolerances: a route calls the same integrator with the same arguments on
the same device, so its image is equal (the PNG bytes, or the
checkpoint's float sum); a resumed run sums its two halves in another
order than one straight run, rtol 1e-5.
"""
import os
import subprocess
import sys
import uuid

import numpy as np
import pytest
import torch
from PIL import Image

from hydracore_tpu.app import cli as jcli
from hydracore_tpu_torch.app import cli
from hydracore_tpu_torch.integrators import bdpt, gbuffer, lt, mlt, mmlt, pt
from hydracore_tpu_torch.parallel import mesh as pm
from hydracore_tpu_torch.scene.library import write_library
from hydracore_tpu_torch.scene.scene import load_scene
from hydracore_tpu_torch.scene.statefile import RenderSettings
from hydracore_tpu_torch.utils import checkpoint as ck
from hydracore_tpu_torch.utils import denoise
from hydracore_tpu_torch.utils.framebuffer import hdr_to_ldr
from hydracore_tpu_torch.utils.shared_image import SharedAccumImage

torch.set_num_threads(1)

ROOT = __file__.rsplit("/tests/", 1)[0]
SEED = 5  # the library's <seed>
DEPTH = 4  # the library's <trace_depth>


def _library(root, extra: str = "", depth: int = DEPTH) -> str:
    root.mkdir(parents=True, exist_ok=True)
    write_library(root, size=8)
    p = root / "statex_00001.xml"
    text = p.read_text().replace("<seed>5</seed>", f"<seed>5</seed>{extra}")
    p.write_text(text.replace("<trace_depth>4</trace_depth>",
                              f"<trace_depth>{depth}</trace_depth>"))
    return str(root)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _library(tmp_path_factory.mktemp("lib"))


@pytest.fixture(scope="module")
def scene(lib):
    return load_scene(lib)


def _run(lib, tmp_path, *flags, name="z.png"):
    out = str(tmp_path / name)
    assert cli.main(["-inputlib", lib, "-out", out, *flags], device="cpu") == 0
    return out


def _png(path):
    return np.asarray(Image.open(path))


ARGVS = [
    ["-inputlib", "x"],
    ["-inputlib", "x", "-out", "a.png", "-spp", "12", "-width", "64",
     "-height", "32", "-method", "ibpt", "-seed", "3", "-gamma", "1.8"],
    ["-inputlib", "x", "-multichip", "1", "-offline_pt", "0", "-evalgbuffer",
     "1", "-checkpoint", "c.npz", "-resume", "r.npz", "-stat", "1",
     "-denoise", "nlm", "-layer", "direct", "-regen", "1"],
    ["-inputlib", "x", "-maxsamples", "7", "-enable_mlt", "1", "-mmltthreads",
     "64", "-outdir", "o", "-logdir", "l", "-listdev", "1", "-sharedimage",
     "s", "-boxmode", "1", "-nowindow", "0", "-port", "0"],
    ["-inputlib", "x", "-cl_device_id", "2", "-cpu_fb", "1",
     "-max_cpu_threads", "4", "-double_rt", "1", "-alloc_image_b", "1",
     "-hydradir", "h", "-outall", "a", "-saveinterval", "2.5",
     "-statefile", "statex_00002.xml", "-cl_list_devices", "0"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parser_parity(argv):
    assert (vars(cli.build_parser().parse_args(argv))
            == vars(jcli.build_parser().parse_args(argv)))


@pytest.mark.parametrize("flags,settings,route", [
    ([], {}, "passes"),
    (["-method", "lt", "-multichip", "1"], {}, "lt"),
    (["-multichip", "1", "-offline_pt", "1"], {}, "multichip"),
    (["-offline_pt", "1"], {}, "offline_pt"),
    ([], {"offline_pt": True}, "offline_pt"),
    (["-offline_pt", "0"], {"offline_pt": True}, "passes"),
    (["-enable_mlt", "1"], {}, "mmlt"),
    (["-enable_mlt", "1", "-method", "sbdpt"], {}, "sbdpt"),
    ([], {"method": "IBPT"}, "ibpt"),
    (["-method", "3way"], {"method": "MMLT"}, "ibpt"),
    (["-method", "pssmlt", "-multichip", "1"], {}, "mlt"),
    (["-method", "rt", "-offline_pt", "1"], {}, "raytracing"),
    (["-method", "LightTracing"], {}, "lt"),
])
def test_route_order(flags, settings, route):
    """-method first, then -multichip, then offline_pt, then the pass loop
    (the JAX package's cli.py:195-245)."""
    args = cli.build_parser().parse_args(["-inputlib", "x", *flags])
    st = RenderSettings(**settings)
    assert cli.route_of(args, st) == route


def test_pt_route_is_render_passes(lib, scene, tmp_path, capsys):
    out = _run(lib, tmp_path, "-spp", "4", "-checkpoint",
               str(tmp_path / "c.npz"))
    text = capsys.readouterr().out
    fb, spp, seed = ck.load_checkpoint(str(tmp_path / "c.npz"))
    ref, _ = pt.render_passes(scene, 0, SEED, n_pass=4, max_depth=DEPTH,
                              device="cpu")
    assert (spp, seed) == (4, SEED) and np.array_equal(fb, ref.numpy())
    assert np.array_equal(_png(out), hdr_to_ldr(fb / 4, gamma=2.2))
    assert text.startswith("[scene] 40 tris, 5 materials, 2 lights, 8x8 (")
    assert "[pass] spp = 4/4, speed = " in text and " M(samples)/s" in text
    assert f"[done] saved {out} in " in text


def test_default_device_is_the_card(lib, tmp_path):
    """Without device= the CLI asks for CUDA, which raises here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU case is the one to test")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-inputlib", lib, "-out", str(tmp_path / "z.png")])


def _direct(route, scene, spp=2):
    if route == "raytracing":
        g = gbuffer.eval_gbuffer(scene, SEED, device="cpu")
        return g["normal"].numpy() * 0.5 + 0.5, 1.0
    if route == "lt":
        img = lt.render_lt(scene, spp, seed=SEED, max_depth=DEPTH, device="cpu")
    elif route == "sbdpt":
        img = bdpt.render_bdpt(scene, spp, seed=SEED, max_depth=DEPTH,
                               device="cpu")
    elif route == "ibpt":
        img = bdpt.render_ibpt(scene, spp, seed=SEED, max_depth=DEPTH,
                               device="cpu")
    elif route == "offline_pt":
        img = pt.render_production(scene, spp, seed=SEED, max_depth=DEPTH,
                                   device="cpu")
    else:  # multichip
        img = pm.render_distributed(scene, spp, seed=SEED, device="cpu")
    return img.numpy(), 2.2


@pytest.mark.parametrize("route,flags", [
    ("raytracing", ["-method", "raytracing"]),
    ("lt", ["-method", "lighttracing"]),
    ("lt", ["-multichip", "1", "-method", "lt"]),
    ("sbdpt", ["-method", "sbdpt"]),
    ("ibpt", ["-method", "ibpt"]),
    ("offline_pt", ["-offline_pt", "1"]),
    ("multichip", ["-multichip", "1"]),
])
def test_route_image_is_its_integrator(lib, scene, tmp_path, capsys, route,
                                       flags):
    out = _run(lib, tmp_path, "-spp", "2", *flags)
    text = capsys.readouterr().out
    img, gamma = _direct(route, scene)
    assert np.array_equal(_png(out), hdr_to_ldr(img, gamma=gamma))
    assert ("[mesh] 1 devices" in text) == (route == "multichip")


@pytest.mark.parametrize("flag,settings,kw", [
    (["-regen", "1"], {}, {"regen": True}),
    (["-layer", "direct"], {"render_layer": "direct"}, {}),
    (["-layer", "indirect"], {"render_layer": "indirect"}, {}),
    (["-double_rt", "1"], {"double_rt": True}, {}),
])
def test_pass_loop_switches(lib, scene, tmp_path, capsys, flag, settings, kw):
    """-regen is render_passes(regen=); -layer and -double_rt set the
    scene's settings."""
    import dataclasses

    _run(lib, tmp_path, "-spp", "3", "-checkpoint", str(tmp_path / "c.npz"),
         *flag)
    fb, _, _ = ck.load_checkpoint(str(tmp_path / "c.npz"))
    sc = dataclasses.replace(scene, settings=dataclasses.replace(
        scene.settings, **settings))
    ref, _ = pt.render_passes(sc, 0, SEED, n_pass=3, max_depth=DEPTH,
                              device="cpu", **kw)
    assert np.array_equal(fb, ref.numpy())
    assert ("-double_rt: float64" in capsys.readouterr().out) == ("double_rt" in settings)


@pytest.fixture(scope="module")
def mlt_lib(tmp_path_factory):
    """Depth 2 and one burn-in round keep the Metropolis routes at a few
    seconds on the CPU."""
    return _library(tmp_path_factory.mktemp("mltlib"),
                    "<mmlt_burn_iters>1</mmlt_burn_iters>", depth=2)


@pytest.mark.parametrize("method,mod,name", [("mlt", mlt, "render_mlt"),
                                             ("mmlt", mmlt, "render_mmlt")])
def test_metropolis_routes(mlt_lib, tmp_path, monkeypatch, method, mod, name):
    """MLT and MMLT take n_passes = max(spp // 4, 8), MMLT n_chains =
    -mmltthreads; the PNG is the integrator's image."""
    calls = []
    real = getattr(mod, name)

    def spy(scene, **kw):
        calls.append((scene, kw, real(scene, **kw)))
        return calls[-1][2]

    monkeypatch.setattr(mod, name, spy)
    out = _run(mlt_lib, tmp_path, "-spp", "2", "-method", method,
               "-mmltthreads", "32")
    (scene, kw, img), = calls
    want = dict(n_passes=8, seed=SEED, max_depth=2, device=torch.device("cpu"))
    if method == "mmlt":
        want["n_chains"] = 32
    assert kw == want
    assert scene.camera.width == 8
    assert np.array_equal(_png(out), hdr_to_ldr(img.numpy(), gamma=2.2))


@pytest.mark.parametrize("kind", ["bilateral", "nlm"])
def test_denoise(lib, tmp_path, kind):
    out = _run(lib, tmp_path, "-spp", "2", "-denoise", kind, "-checkpoint",
               str(tmp_path / "c.npz"))
    fb, spp, _ = ck.load_checkpoint(str(tmp_path / "c.npz"))
    f = denoise.bilateral_filter if kind == "bilateral" else denoise.nlm_filter
    want = f(torch.as_tensor(fb / spp)).numpy()
    assert np.array_equal(_png(out), hdr_to_ldr(want, gamma=2.2))


def test_evalgbuffer_and_stat(lib, scene, tmp_path, capsys):
    out = _run(lib, tmp_path, "-spp", "1", "-evalgbuffer", "1", "-stat", "1",
               "-cl_device_id", "1")
    text = capsys.readouterr().out
    g = gbuffer.eval_gbuffer(scene, SEED, device="cpu")
    base = out.rsplit(".", 1)[0]
    assert np.array_equal(_png(base + "_normal.png"),
                          hdr_to_ldr(g["normal"].numpy() * 0.5 + 0.5, gamma=1.0))
    assert _png(base + "_depth.png").shape == (8, 8, 3)
    assert f"[gbuffer] saved {base}_normal.png, {base}_depth.png" in text
    assert "[stat] rays/sec(" in text and "trace%(" in text
    assert "[config] -cl_device_id accepted, no-op" in text


def test_resume_takes_the_checkpoint_seed(lib, tmp_path, capsys):
    """2 + 2 passes through a checkpoint against a straight 4; the resumed
    run takes the checkpoint's seed (9), not the library's (5)."""
    a, b, c = (str(tmp_path / f"{k}.npz") for k in "abc")
    _run(lib, tmp_path, "-spp", "4", "-seed", "9", "-checkpoint", a)
    _run(lib, tmp_path, "-spp", "2", "-seed", "9", "-checkpoint", b)
    _run(lib, tmp_path, "-spp", "4", "-resume", b, "-checkpoint", c)
    assert f"[resume] {b}: spp=2" in capsys.readouterr().out
    fa, spp_a, _ = ck.load_checkpoint(a)
    fc, spp_c, seed_c = ck.load_checkpoint(c)
    assert (spp_a, spp_c, seed_c) == (4, 4, 9)
    np.testing.assert_allclose(fc, fa, rtol=1e-5, atol=1e-6)


def test_exitnow_through_the_control_file(lib, tmp_path, capsys):
    out = str(tmp_path / "z.png")
    with open(out + ".ctl", "w") as f:
        f.write("exitnow")
    _run(lib, tmp_path, "-spp", "16", "-checkpoint", str(tmp_path / "c.npz"))
    assert "[exitnow] stopping at spp=8" in capsys.readouterr().out
    assert not os.path.exists(out + ".ctl")
    assert ck.load_checkpoint(str(tmp_path / "c.npz"))[1] == 8


def test_exitnow_through_the_shared_image(lib, tmp_path, capsys):
    name = f"tc_{uuid.uuid4().hex[:8]}"
    img = SharedAccumImage.create(name, 8, 8)
    try:
        img.send_message("exitnow")
        _run(lib, tmp_path, "-spp", "16", "-sharedimage", name)
        text = capsys.readouterr().out
        assert "[exitnow] stopping at spp=8" in text
        assert "[sharedimage] combined spp = 8" in text
        assert img.read()[1] == 8
    finally:
        img.unlink()


def test_adaptive_stop_only_every_32(tmp_path, capsys):
    """minRaysPerPixel 8, pt_error 50%: the first check (spp 32) only
    records the frame; the second (spp 64) stops."""
    lib = _library(tmp_path / "lib", "<minRaysPerPixel>8</minRaysPerPixel>"
                   "<pt_error>50</pt_error>")
    _run(lib, tmp_path, "-spp", "96", "-checkpoint", str(tmp_path / "c.npz"))
    text = capsys.readouterr().out
    assert "[adaptive] stop at spp=64: err " in text
    assert text.count("[adaptive]") == 1
    assert "[pass] spp = 64/64, speed" in text
    assert ck.load_checkpoint(str(tmp_path / "c.npz"))[1] == 64


def test_logdir_tees_and_restores_stdout(lib, tmp_path):
    before = sys.stdout
    _run(lib, tmp_path, "-spp", "1", "-logdir", str(tmp_path / "logs"))
    assert sys.stdout is before
    log = (tmp_path / "logs" / "hydra_log.txt").read_text()
    assert log.startswith("[scene] ") and "[done] saved" in log


def test_listdevices_and_module_entry(lib):
    out = subprocess.run([sys.executable, "-m", "hydracore_tpu_torch.app.cli",
                          "-inputlib", lib, "-listdevices", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n = torch.cuda.device_count()
    assert out.stdout.count("[device] ") == max(n, 1)


def test_two_process_shared_image_merge(lib, tmp_path):
    """Two CLI processes with different -seed add into one shared image:
    the combined spp is the sum, the combined sum the sum of theirs."""
    name = f"tc_{uuid.uuid4().hex[:8]}"

    def run(seed):
        args = ["-inputlib", lib, "-out", str(tmp_path / f"{seed}.png"),
                "-spp", "4", "-seed", str(seed), "-sharedimage", name,
                "-checkpoint", str(tmp_path / f"{seed}.npz")]
        code = ("import sys, torch; torch.set_num_threads(1);"
                "from hydracore_tpu_torch.app.cli import main;"
                f"sys.exit(main({args!r}, device='cpu'))")
        return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    procs = [run(1), run(2)]
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    img = SharedAccumImage.attach(name)
    try:
        fb, spp = img.read()
        assert spp == 8
        f1 = ck.load_checkpoint(str(tmp_path / "1.npz"))[0]
        f2 = ck.load_checkpoint(str(tmp_path / "2.npz"))[0]
        np.testing.assert_allclose(fb, f1 + f2, rtol=1e-6, atol=1e-7)
        assert any("[sharedimage] combined spp = 8" in log for log in logs)
        last = logs[0] if "combined spp = 8" in logs[0] else logs[1]
        seed = 1 if last is logs[0] else 2
        assert np.array_equal(_png(str(tmp_path / f"{seed}.png")),
                              hdr_to_ldr(fb / 8, gamma=2.2))
    finally:
        img.unlink()
