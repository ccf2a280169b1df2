"""The port's shared accumulator image (utils/shared_image.py) against the
JAX package's: one header format and one path, so either package creates
an image and both attach and add to it; the round trip, the concurrent
adds, the message channel and the pooled MLT b of
tests/test_shared_image.py, mirrored on the port's class.

The sums are float32 adds of the same values in the same order, so every
check is exact (rtol 1e-6 where the JAX test has it).
"""
import subprocess
import sys
import threading
import uuid

import numpy as np
import pytest

from hydracore_tpu.utils import shared_image as jsi
from hydracore_tpu_torch.utils import shared_image as psi

ROOT = __file__.rsplit("/tests/", 1)[0]


def test_same_header_and_path():
    assert psi._HDR_FMT == jsi._HDR_FMT == "<IIIIdQdd64s"
    assert psi._MAGIC == jsi._MAGIC and psi._VER == jsi._VER
    assert psi._shm_path("x") == jsi._shm_path("x")


@pytest.mark.parametrize("creator", ["jax", "port"])
def test_cross_package_attach_and_add(creator):
    name = f"tp_{uuid.uuid4().hex[:8]}"
    mine, other = (jsi, psi) if creator == "jax" else (psi, jsi)
    img = mine.SharedAccumImage.create(name, 8, 6)
    try:
        a = np.random.default_rng(1).random((6, 8, 3)).astype(np.float32)
        b = np.random.default_rng(2).random((6, 8, 3)).astype(np.float32)
        assert img.add(a, 4, b_sum_delta=3.0, b_weight_delta=1.0) == 4
        att = other.SharedAccumImage.attach(name)
        assert (att.width, att.height) == (8, 6)
        assert att.add(b, 8, b_sum_delta=1.0, b_weight_delta=1.0) == 12
        for im in (img, att):
            fb, spp = im.read()
            assert spp == 12
            assert np.array_equal(fb, a + b)
            assert im.read_b() == 2.0
        att.send_message("exitnow")
        assert img.recv_message() == "exitnow"
        # attach_or_create from the other package finds the same image
        again = other.SharedAccumImage.attach_or_create(name, 8, 6)
        assert again.read()[1] == 12
        with pytest.raises(ValueError):
            other.SharedAccumImage.attach_or_create(name, 4, 4)
        again.close()
        att.close()
    finally:
        img.unlink()


def test_roundtrip_and_concurrent_adds():
    """tests/test_shared_image.py's case on the port's class, the
    concurrent adders alternating between the two packages."""
    name = f"tp_{uuid.uuid4().hex[:8]}"
    img = psi.SharedAccumImage.create(name, 8, 6)
    try:
        a = np.random.default_rng(1).random((6, 8, 3)).astype(np.float32)
        b = np.random.default_rng(2).random((6, 8, 3)).astype(np.float32)
        assert img.add(a, 4) == 4
        att = psi.SharedAccumImage.attach(name)
        assert att.add(b, 8) == 12
        fb, spp = img.read()
        assert spp == 12
        np.testing.assert_allclose(fb, a + b, rtol=1e-6)
        one = np.ones((6, 8, 3), np.float32)
        mods = [psi, jsi] * 4
        ts = [threading.Thread(
            target=lambda m=m: m.SharedAccumImage.attach(name).add(one, 1))
            for m in mods]
        [t.start() for t in ts]
        [t.join(timeout=60) for t in ts]
        assert not any(t.is_alive() for t in ts)
        fb2, spp2 = img.read()
        assert spp2 == 20
        np.testing.assert_allclose(fb2, a + b + 8.0, rtol=1e-6)
        img.send_message("exitnow")
        assert att.recv_message() == "exitnow"
        img.clear()
        fb3, spp3 = img.read()
        assert spp3 == 0 and fb3.max() == 0
        att.close()
    finally:
        img.unlink()


def test_mlt_b_pooled_across_processes():
    """Two worker processes, one of each package, publish (b_sum,
    b_weight); the pooled b is their sum over their weight."""
    name = f"tp_{uuid.uuid4().hex[:8]}"
    img = psi.SharedAccumImage.create(name, 4, 4)
    try:
        worker = (
            "import numpy as np, sys, importlib;"
            "m = importlib.import_module(sys.argv[4]);"
            "im = m.SharedAccumImage.attach(sys.argv[1]);"
            "im.add(np.ones((4, 4, 3), np.float32), 1,"
            "       b_sum_delta=float(sys.argv[2]),"
            "       b_weight_delta=float(sys.argv[3]))")
        procs = [subprocess.Popen(
            [sys.executable, "-c", worker, name, str(b), str(w), mod],
            cwd=ROOT)
            for b, w, mod in ((6.0, 3.0, "hydracore_tpu_torch.utils.shared_image"),
                              (2.0, 1.0, "hydracore_tpu.utils.shared_image"))]
        for p in procs:
            assert p.wait(timeout=120) == 0
        # pooled b = (6 + 2) / (3 + 1) = 2.0, not the mean of 2.0 and 2.0
        # weighted equally by accident: the weights differ
        assert abs(img.read_b() - 2.0) < 1e-12
        fb, spp = img.read()
        assert spp == 2 and np.array_equal(fb, np.full((4, 4, 3), 2.0, np.float32))
        img.send_message("hello")
        assert abs(img.read_b() - 2.0) < 1e-12
        assert jsi.SharedAccumImage.attach(name).recv_message() == "hello"
    finally:
        img.unlink()


def test_attach_missing_raises():
    with pytest.raises(FileNotFoundError):
        psi.SharedAccumImage.attach(f"nosuch_{uuid.uuid4().hex[:8]}")
