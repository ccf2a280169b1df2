"""Build native code of the port into its git-ignored build directory.

The sources are compiled at first use, never next to the source and never
at import time:
  * csrc/bvh_builder.cpp    -> _build/libbvh_builder.so   (g++, host)
  * csrc/traverse_cluster.cu -> _build/libtraverse_cluster.so (nvcc, sm_90a)
  * csrc/traverse_packet.cu -> _build/libtraverse_packet.so (nvcc, sm_90a)
  * csrc/traverse_dense.cu  -> _build/libtraverse_dense.so  (nvcc, sm_90a)
and the kernel lab's (hydracore_tpu_torch/tools/), nvcc for sm_90a each:
  * csrc/lab_gather.cu, csrc/lab_prims.cu, csrc/lab_subvisit.cu,
    csrc/lab_cluster_cost.cu, csrc/lab_cluster.cu, csrc/lab_packet.cu
    -> _build/lib<name>.so
(chip_smoke.py builds them all in its phase 1 and holds the lab's kernels
against their plain versions in phases 12 and 13)

All expose a plain C interface loaded with ctypes (load_lib), so a build
takes seconds (no PyTorch headers); launch() calls a kernel's C function on
a tensor's card and raises if the launch failed. Outputs are written under
a temporary name and renamed into place, so concurrent processes (test
workers) never load a half-written library.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import torch

VP, CI = ctypes.c_void_p, ctypes.c_int

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

GXX_FLAGS = ["-O2", "-march=native", "-shared", "-fPIC"]
# --fmad=false: the kernel's slab and Woop arithmetic rounds like the plain
# PyTorch twin (separate mul and add); no --use_fast_math, so -ow/dw keeps
# IEEE division and the inf/NaN results that make parallel rays miss.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false"]


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name)


def lib_path(src_name: str) -> str:
    stem = os.path.splitext(src_name)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}.so")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build_command(src_name: str, out: str) -> list[str]:
    src = source_path(src_name)
    if src_name.endswith(".cu"):
        return [nvcc_path(), *NVCC_FLAGS, "-o", out, src]
    return ["g++", *GXX_FLAGS, "-o", out, src]


def is_stale(src_name: str) -> bool:
    so = lib_path(src_name)
    return (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(source_path(src_name)))


def start_build(src_name: str):
    """Start compiling `src_name` if its library is stale. Returns
    (Popen, tmp_out) or None when the library is current; finish with
    finish_build. Lets a caller run several compilers at once."""
    if not is_stale(src_name):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.Popen(build_command(src_name, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError:
        os.unlink(tmp)
        raise
    return proc, tmp


def finish_build(src_name: str, started) -> str:
    """Wait for a build from start_build; raise with the compiler's output
    if it failed. Returns the library path."""
    out = lib_path(src_name)
    if started is None:
        return out
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {src_name} failed:\n{log}")
    os.replace(tmp, out)
    return out


def build(src_name: str) -> str:
    """Compile `src_name` from csrc/ if stale; returns the library path."""
    return finish_build(src_name, start_build(src_name))


def load_lib(src_name: str, fn_name: str, argtypes: list,
             err_fn: str = "hydra_cuda_error_string"):
    """Build csrc/`src_name` if stale and load it. `fn_name` takes
    `argtypes` and returns a CUDA error code (0 on success), which the
    library's `err_fn` turns into text."""
    lib = ctypes.CDLL(build(src_name))
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = CI
    err = getattr(lib, err_fn)
    err.argtypes = [CI]
    err.restype = ctypes.c_char_p
    return lib


def launch(lib, fn_name: str, what: str, device, *args,
           err_fn: str = "hydra_cuda_error_string") -> None:
    """Call lib.`fn_name`(*args, stream) with `device` the current card and
    its current stream; raise with the error's text if the launch failed."""
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = getattr(lib, err_fn)(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")
