"""The PyTorch port imports nothing of JAX, flax, the JAX package or the
JAX package's tools/.

A source scan of every module of hydracore_tpu_torch/ and chip_smoke.py,
and an import of every module in a fresh interpreter that must leave jax
out of sys.modules.
"""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|hydracore_tpu|tools)(\.|\s|$)",
    re.M)


def _sources():
    files = sorted((ROOT / "hydracore_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_sources_import_no_jax():
    files = _sources()
    assert len(files) > 19
    names = {str(f.relative_to(ROOT / "hydracore_tpu_torch")) for f in files[:-1]}
    # the host compiler and the instanced layout are scanned too, and the
    # port's own procedural-texture evaluator (the JAX materials compiler
    # imports the JAX one)
    assert {"scene/vsgf.py", "scene/statefile.py", "scene/textures.py",
            "scene/materials.py", "scene/lights.py", "lights/ies.py",
            "bvh/instanced.py", "bvh/clusters.py", "bvh/wide.py",
            "ops/trace_api.py", "ops/traverse_dense.py", "ops/traverse_wide.py",
            "ops/traverse_packet.py", "ops/proctex.py", "ops/proctex_c.py",
            "integrators/pt_regen.py", "integrators/lt.py",
            "integrators/gbuffer.py", "integrators/oracle.py",
            "integrators/bdpt.py", "integrators/mlt.py",
            "integrators/mmlt.py",
            "tools/bench_pallas_gather.py",
            "tools/proto_prims.py", "tools/proto_subvisit.py",
            "tools/exp_kernel_cost.py", "tools/proto_cluster.py",
            "tools/proto_packet.py", "tools/proto_packet2.py",
            "utils/lab.py", "utils/framebuffer.py", "utils/checkpoint.py",
            "utils/denoise.py", "utils/stats.py", "utils/shared_image.py",
            "bsdf/energy_tables.py", "parallel/mesh.py", "app/cli.py",
            "app/cam_plugin.py", "app/viewer.py", "scene/library.py"} <= names
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad


def test_import_leaves_jax_unloaded():
    code = (
        "import importlib, pkgutil, sys, runpy\n"
        "import hydracore_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'hydracore_tpu', 'tools'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith(pkg.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 15
