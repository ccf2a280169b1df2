"""Cross-process shared framebuffer accumulator: the IHRSharedAccumImage role.

The reference scales across GPUs by running ONE RENDERER PROCESS PER DEVICE,
all attached to a named OS shared-memory image (header with spp/message
fields + float4 accumulator) guarded by a system mutex: README "rendering on
2 GPUs", hydra_app/main.cpp:224-241 (Attach / boxmode fallback),
RenderDriverRTE.h:320 (the header/lock/message interface),
GPUOCLLayerOther.cpp:140-166 + 248-300 (per-pass Lock -> add -> Unlock).

In-process multi-card rendering goes through torch.distributed
(parallel/mesh.py). This module covers the case the shared image solves:
separate OS processes, one per card or render-farm nodes on a shared
filesystem, accumulating raw HDR passes into one frame. The buffer is a
numpy memmap in /dev/shm (POSIX shm); `fcntl.flock` is the system mutex;
accumulate-raw / normalize-at-read keeps the framebuffer contract
(utils/framebuffer.py).

The JAX package's utils/shared_image.py keeps the same header
(_HDR_FMT, _MAGIC, version 2), the same path /dev/shm/hydra_shared_<name>
and the same locking, so a process of either package may create an image
and processes of both may add into it.
"""
from __future__ import annotations

import fcntl
import os
import struct

import numpy as np

_MAGIC = 0x48594452  # 'HYDR'
# magic, version, W, H, spp, counter, b_sum, b_weight, message.
# b_sum/b_weight: pooled MLT normalization estimator — the reference
# publishes avgBrightness through the shared image header so a master can
# tone-map multi-process MLT (GPUOCLLayerAdvanced.cpp:422-423); the pooled
# (sum, weight) pair lets N processes combine their estimates exactly.
_HDR_FMT = "<IIIIdQdd64s"
_HDR_SIZE = struct.calcsize(_HDR_FMT)
_VER = 2


def _shm_path(name: str) -> str:
    base = "/dev/shm" if os.path.isdir("/dev/shm") else None
    if base is None:
        import tempfile

        base = tempfile.gettempdir()
    return os.path.join(base, f"hydra_shared_{name}")


class SharedAccumImage:
    """Named shared HDR accumulator: (H, W, 3) float32 raw sums + spp.

    create() once, attach() from any process; add() accumulates a pass
    delta under an exclusive lock; read() returns (copy, spp). The 64-byte
    message field is the reference's message channel (exitnow etc.)."""

    def __init__(self, path: str):
        self.path = path
        # unbuffered: the header is shared mutable state — a buffered file
        # object would satisfy re-reads from its own stale cache
        self._f = open(path, "r+b", buffering=0)
        for _retry in range(50):  # creator may still be writing the header
            try:
                magic, ver, self.width, self.height = \
                    self._read_header()[:4]
            except struct.error:
                magic = 0
            if magic == _MAGIC:
                break
            import time

            time.sleep(0.02)
        else:
            raise ValueError(f"{path} is not a hydra shared image")

    # ---- lifecycle
    @classmethod
    def create(cls, name: str, width: int, height: int) -> "SharedAccumImage":
        path = _shm_path(name)
        size = _HDR_SIZE + width * height * 3 * 4
        with open(path, "wb") as f:
            f.write(struct.pack(_HDR_FMT, _MAGIC, _VER, width, height, 0.0,
                                0, 0.0, 0.0, b"\0" * 64))
            f.truncate(size)
        return cls(path)

    @classmethod
    def attach(cls, name: str) -> "SharedAccumImage":
        path = _shm_path(name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no shared image {name!r} (create it first)")
        return cls(path)

    @classmethod
    def attach_or_create(cls, name: str, width: int,
                         height: int) -> "SharedAccumImage":
        """First renderer process creates, the rest attach (the reference
        leaves creation to the master; standalone runs self-host)."""
        path = _shm_path(name)
        # O_EXCL so exactly one of N racing processes creates
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            img = cls(path)
            if (img.width, img.height) != (width, height):
                raise ValueError(
                    f"shared image {name!r} is {img.width}x{img.height}, "
                    f"renderer wants {width}x{height}")
            return img
        with os.fdopen(fd, "wb") as f:
            f.write(struct.pack(_HDR_FMT, _MAGIC, _VER, width, height, 0.0,
                                0, 0.0, 0.0, b"\0" * 64))
            f.truncate(_HDR_SIZE + width * height * 3 * 4)
        return cls(path)

    def close(self):
        self._f.close()

    def unlink(self):
        self.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    # ---- header
    def _read_header(self):
        self._f.seek(0)
        return struct.unpack(_HDR_FMT, self._f.read(_HDR_SIZE))

    def _write_header(self, spp: float, counter: int, msg: bytes,
                      b_sum: float = 0.0, b_weight: float = 0.0):
        self._f.seek(0)
        self._f.write(struct.pack(_HDR_FMT, _MAGIC, _VER, self.width,
                                  self.height, spp, counter, b_sum,
                                  b_weight, msg))
        self._f.flush()

    # ---- the accumulator protocol (Lock -> add -> Unlock)
    def add(self, fb_delta: np.ndarray, spp_delta: float,
            b_sum_delta: float = 0.0, b_weight_delta: float = 0.0) -> float:
        """Accumulate raw HDR sums; returns the combined spp after the add
        (the reference's counterRcv++ bookkeeping rides the same lock).
        MLT processes also pool their normalization estimator through
        (b_sum_delta, b_weight_delta) — see read_b()."""
        fb_delta = np.ascontiguousarray(fb_delta, np.float32)
        assert fb_delta.shape == (self.height, self.width, 3)
        fcntl.flock(self._f, fcntl.LOCK_EX)
        try:
            _, _, _, _, spp, counter, b_s, b_w, msg = self._read_header()
            mm = np.memmap(self.path, np.float32, "r+", offset=_HDR_SIZE,
                           shape=(self.height, self.width, 3))
            mm += fb_delta
            mm.flush()
            del mm
            spp += float(spp_delta)
            self._write_header(spp, counter + 1, msg,
                               b_s + float(b_sum_delta),
                               b_w + float(b_weight_delta))
            return spp
        finally:
            fcntl.flock(self._f, fcntl.LOCK_UN)

    def read_b(self) -> float:
        """Pooled MLT normalization constant b = sum / weight over every
        process's contribution (0 when no MLT process reported one) —
        the avgBrightness header channel of GPUOCLLayerAdvanced.cpp:422."""
        fcntl.flock(self._f, fcntl.LOCK_SH)
        try:
            h = self._read_header()
            b_s, b_w = h[6], h[7]
            return b_s / b_w if b_w > 0 else 0.0
        finally:
            fcntl.flock(self._f, fcntl.LOCK_UN)

    def read(self):
        """(accumulated HDR sums copy, spp). Normalize by spp at readback."""
        fcntl.flock(self._f, fcntl.LOCK_SH)
        try:
            spp = self._read_header()[4]
            mm = np.memmap(self.path, np.float32, "r", offset=_HDR_SIZE,
                           shape=(self.height, self.width, 3))
            return np.asarray(mm).copy(), spp
        finally:
            fcntl.flock(self._f, fcntl.LOCK_UN)

    def clear(self):
        fcntl.flock(self._f, fcntl.LOCK_EX)
        try:
            mm = np.memmap(self.path, np.float32, "r+", offset=_HDR_SIZE,
                           shape=(self.height, self.width, 3))
            mm[:] = 0.0
            mm.flush()
            del mm
            self._write_header(0.0, 0, b"\0" * 64)
        finally:
            fcntl.flock(self._f, fcntl.LOCK_UN)

    # ---- message channel (MessageSendData/MessageRcvData)
    def send_message(self, text: str):
        fcntl.flock(self._f, fcntl.LOCK_EX)
        try:
            h = self._read_header()
            spp, counter, b_s, b_w = h[4], h[5], h[6], h[7]
            self._write_header(spp, counter,
                               text.encode()[:64].ljust(64, b"\0"),
                               b_s, b_w)
        finally:
            fcntl.flock(self._f, fcntl.LOCK_UN)

    def recv_message(self) -> str:
        fcntl.flock(self._f, fcntl.LOCK_SH)
        try:
            msg = self._read_header()[8]
            return msg.split(b"\0", 1)[0].decode(errors="replace")
        finally:
            fcntl.flock(self._f, fcntl.LOCK_UN)
