"""The port's kernel lab (hydracore_tpu_torch/tools/) against the JAX
package's tools (tools/*.py), on the CPU.

Each JAX tool is loaded by file path (tools/ is no package) while
jax.experimental.pallas.pallas_call is wrapped to run in interpret mode;
the jax_compilation_cache_dir that every tool sets at import (a path of
its own machine) is not applied, and the setting is put back after the
import all the same. Inputs come from numpy with fixed seeds; the port runs its
plain versions (CPU tensors). The kernels themselves are held against the
same plain versions on the card by tests/test_torch_card.py.

Tolerances:
  * T7 gathers: bit-equal. Both sum the rows in iteration order from 0;
    the one-hot bf16 matmul with f32 accumulation yields each bf16-rounded
    row of a finite pool exactly, so onehot is bit-equal to the sum of
    rounded rows (tests/test_torch_lab_gather.py holds the hard inputs:
    the int32 wrap, non-finite pools, other S and iteration counts).
  * T6 probes: equal (integer-valued inputs, sums in index order); k8 on
    its adversarial inputs (a NaN, a row of -inf, ties of -0.0 and +0.0)
    equal bit for bit too: NaN, -inf and the closing + 0.0 leave one
    answer whatever order the maxima are taken in.
  * T5 sub-visits: the winning lane (the low 7 bits of the output word)
    equal on >= 99.9% of rays, the whole word on >= 99%, and t with the
    lane bits cleared within rtol 1e-4 (tests/test_torch_traverse_cluster.py's
    tolerance for the same Woop test). Not bit-equal: XLA:CPU contracts the
    interpret-mode multiply-adds of ow and dw into FMAs (a jitted
    ox*bx + oy*by + oz*bz + bc differs from the separate f32 operations in
    a fifth of the lanes), the port and its kernel round every operation,
    and -ow/dw cancels, so t moves by up to ~1e-5 relative on a few rays.
    On t5.adversarial_inputs (axis rays against rows of small dyadic values,
    where every order of rounding agrees) the words are equal bit for bit;
    XLA:CPU flushes subnormals to zero, so the "subnormal" case is held
    against the plain version of its inputs with their subnormals flushed
    to signed zeros (the case makes no subnormal from normal values).
  * T1 cost variants: floor bit-equal (a copy), the occupancy word and the
    entered-position counts equal, also on t1.adversarial_inputs (NaN
    origins, |d| < 1e-12 of both signs and -0.0, boxes at +-1e30, inverted
    boxes, Cp 400) for every block with a live ray.
"""
import collections
import functools
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hydracore_tpu.scene.procedural import SceneBuilder as JaxBuilder
from hydracore_tpu_torch.tools import bench_pallas_gather as t7
from hydracore_tpu_torch.tools import exp_kernel_cost as t1
from hydracore_tpu_torch.tools import proto_prims as t6
from hydracore_tpu_torch.tools import proto_subvisit as t5
from tests.test_torch_scene import build_with, rects_recipe, to_port

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
_PALLAS_CALL = pl.pallas_call
_JIT = jax.jit


def _load_tool(name: str, mp):
    """Import tools/<name>.py under `mp` (a MonkeyPatch) with pallas_call
    in interpret mode, without the tool's cache-dir setting, and with
    sys.path as it was before (some tools put a directory of their own
    machine in front of it)."""
    mp.setattr(pl, "pallas_call", functools.partial(_PALLAS_CALL, interpret=True))
    saved = jax.config.jax_compilation_cache_dir
    update = jax.config.update

    def update_but_cache_dir(key, value):
        if key != "jax_compilation_cache_dir":
            update(key, value)

    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as cfg:
        cfg.setattr(jax.config, "update", update_but_cache_dir)
        cfg.setattr(sys, "path", list(sys.path))
        try:
            spec.loader.exec_module(mod)
        finally:
            update("jax_compilation_cache_dir", saved)
    return mod


@pytest.mark.parametrize("name", ["bench_pallas_gather", "exp_kernel_cost",
                                  "proto_cluster", "proto_packet",
                                  "proto_packet2", "proto_prims",
                                  "proto_subvisit"])
def test_load_tool_leaves_path_and_cache_dir(name, monkeypatch):
    """Loading a tool changes neither sys.path nor the cache dir, so later
    imports of the same test process read this checkout."""
    path, cache = list(sys.path), jax.config.jax_compilation_cache_dir
    _load_tool(name, monkeypatch)
    assert sys.path == path
    assert jax.config.jax_compilation_cache_dir == cache


class _JitRecorder:
    """Stands in for jax.jit: records the output of each outermost call of
    a jitted function and hands it back on that function's later calls
    (the tools call one function several times to time it)."""

    def __init__(self):
        self.outs = []
        self._depth = 0

    def jit(self, f, *args, **kwargs):
        g = _JIT(f, *args, **kwargs)
        memo = []

        def call(*a, **k):
            if memo:
                return memo[0]
            self._depth += 1
            try:
                r = g(*a, **k)
            finally:
                self._depth -= 1
            if self._depth == 0:
                memo.append(r)
                self.outs.append(np.asarray(r))
            return r
        return call


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


# ---------------------------------------------------------------- T7 gathers

@pytest.mark.parametrize("kern", ["taa", "onehot"])
def test_gather_matches_tool(kern, monkeypatch):
    mod = _load_tool("bench_pallas_gather", monkeypatch)
    R = 2 * mod.BLK
    monkeypatch.setattr(mod, "R", R)
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(mod.S, 128)).astype(np.float32)
    idx = rng.integers(0, mod.S, (R, 1)).astype(np.int32)
    rec = _JitRecorder()
    monkeypatch.setattr(jax, "jit", rec.jit)
    mod.run(getattr(mod, f"kern_{kern}"), kern, jnp.asarray(pool),
            jnp.asarray(idx))
    (out_j,) = rec.outs
    before = dict(t7.launches)
    out_p = t7.gather(torch.tensor(pool), torch.tensor(idx),
                      onehot=kern == "onehot")
    assert t7.launches == before  # plain version
    assert out_p.shape == (R, 128)
    assert np.array_equal(_bits(out_p.numpy()), _bits(out_j))


# ----------------------------------------------------------------- T6 probes

@pytest.fixture(scope="module")
def prim_outputs():
    """The tool's ten probe rows, from the import that runs them."""
    rec = _JitRecorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", rec.jit)
        mod = _load_tool("proto_prims", mp)
    assert len(rec.outs) == 10  # every probe ran (a FAIL records nothing)
    return mod, rec.outs


@pytest.mark.parametrize("k", range(1, 11))
def test_prim_matches_tool(prim_outputs, k):
    mod, outs = prim_outputs
    x = torch.tensor(np.asarray(mod.x))
    xi = torch.tensor(np.asarray(mod.xi))
    out_p = t6.prim(k, x, xi)
    assert out_p.shape == (1, 128) and out_p.dtype == torch.float32
    assert np.array_equal(_bits(out_p.numpy()), _bits(outs[k - 1]))


@pytest.mark.parametrize("name", ["nan", "neg_inf", "zero_tie", "zero_row"])
def test_prim_k8_adversarial_matches_tool(prim_outputs, name, monkeypatch):
    """The tool's k8 (run through its probe(), pallas_call in interpret
    mode) on t6.adversarial_inputs: the plain version's row, bit for bit."""
    mod, _ = prim_outputs
    x, xi = t6.adversarial_inputs("cpu")[name]
    rec = _JitRecorder()
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(_PALLAS_CALL, interpret=True))
    monkeypatch.setattr(jax, "jit", rec.jit)
    mod.probe(name, mod.k8, jnp.asarray(x.numpy()))
    (out_j,) = rec.outs
    out_p = t6.prim(8, x, xi)
    assert np.array_equal(_bits(out_p.numpy()), _bits(out_j))
    want = {"nan": np.isnan, "neg_inf": np.isneginf,
            "zero_tie": lambda v: _bits(v) == 0}.get(name, np.isfinite)
    assert want(out_p.numpy()).all()


# ------------------------------------------------------------- T5 sub-visits

@pytest.fixture(scope="module")
def subvisit_inputs():
    """G = 4 ray blocks of random rays among the 350 rects, V = 16 visits of
    the scene's real clusters (Woop blocks cl_tris)."""
    js = build_with(JaxBuilder, rects_recipe)
    tris = np.asarray(js.cl_tris)
    real = np.flatnonzero(np.asarray(js.cl_bounds)[0] < 1e29)
    rng = np.random.default_rng(5)
    G = 4
    rays = np.zeros((G * 256, 8), np.float32)
    rays[:, 0:3] = rng.uniform(-6, 6, (G * 256, 3))
    d = rng.normal(size=(G * 256, 3))
    rays[:, 3:6] = d / np.linalg.norm(d, axis=1, keepdims=True)
    lst = rng.choice(real, 16).astype(np.int32)
    return G, rays, tris, lst


@pytest.mark.parametrize("name", ["plain", "sub8/repeat", "sub8/concat",
                                  "sub4/concat"])
def test_subvisit_matches_tool(subvisit_inputs, name, monkeypatch):
    G, rays, tris, lst = subvisit_inputs
    n_bands, interleave = t5.VARIANTS[name]
    mod = _load_tool("proto_subvisit", monkeypatch)
    kern = (mod.make_plain(16) if n_bands == 1
            else mod.make_sub(16 // n_bands, n_bands, interleave))
    rec = _JitRecorder()
    monkeypatch.setattr(jax, "jit", rec.jit)
    mod.run(kern, G, jnp.asarray(rays), jnp.asarray(tris), jnp.asarray(lst))
    (out_j,) = rec.outs
    out_p = t5.subvisit(torch.tensor(rays), torch.tensor(tris),
                        torch.tensor(lst), n_bands, interleave).numpy()
    assert out_p.shape == out_j.shape == (G * 256, 1)
    hit = out_j < 1e38
    assert 20 < hit.sum() < hit.size - 20  # some rays hit, some miss
    wp, wj = _bits(out_p), _bits(out_j)
    assert ((wp & 127) == (wj & 127)).mean() >= 0.999
    assert (wp == wj).mean() >= 0.99
    clear = lambda w: (w & np.int32(-128)).view(np.float32)  # noqa: E731
    np.testing.assert_allclose(clear(wp), clear(wj), rtol=1e-4)


def _flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """x with every subnormal replaced by a zero of its sign."""
    small = (x != 0) & (x.abs() < 2.0 ** -126)
    return torch.where(small, torch.copysign(torch.zeros_like(x), x), x)


@pytest.mark.parametrize("name", t5.ADVERSARIAL)
def test_subvisit_adversarial_matches_tool(name, monkeypatch):
    """t5.adversarial_inputs through the tool and the plain version, every
    variant: the tolerances of the module docstring and, on these exact
    inputs, every word equal; "subnormal" against the plain version of the
    flushed inputs, which the unflushed one is not (the tool's machine
    flushes subnormals)."""
    rays, tris, lst = t5.adversarial_inputs()[name]
    mod = _load_tool("proto_subvisit", monkeypatch)
    for variant, (n_bands, interleave) in t5.VARIANTS.items():
        kern = (mod.make_plain(t5.ADV_V) if n_bands == 1
                else mod.make_sub(t5.ADV_V // n_bands, n_bands, interleave))
        rec = _JitRecorder()
        with pytest.MonkeyPatch.context() as jit:
            jit.setattr(jax, "jit", rec.jit)
            mod.run(kern, t5.ADV_G, jnp.asarray(rays.numpy()),
                    jnp.asarray(tris.numpy()), jnp.asarray(lst.numpy()))
        (out_j,) = rec.outs
        args = ((_flush_subnormals(rays), _flush_subnormals(tris))
                if name == "subnormal" else (rays, tris))
        out_p = t5.subvisit(*args, lst, n_bands, interleave).numpy()
        wp, wj = _bits(out_p), _bits(out_j)
        assert ((wp & 127) == (wj & 127)).mean() >= 0.999, variant
        assert (wp == wj).mean() >= 0.99, variant
        clear = lambda w: (w & np.int32(-128)).view(np.float32)  # noqa: E731
        np.testing.assert_allclose(clear(wp), clear(wj), rtol=1e-4)
        assert np.array_equal(wp, wj), variant
        hit = out_p < 1e38
        assert 0 < hit.sum() < hit.size, variant
        if name == "subnormal":
            raw = _bits(t5.subvisit(rays, tris, lst, n_bands, interleave).numpy())
            assert not np.array_equal(raw, wj), variant


def test_subvisit_repeat_and_concat_differ(subvisit_inputs):
    """pltpu.repeat tiles the stacked rows, so its groups interleave: the
    two operand builds of the tool are two functions."""
    G, rays, tris, lst = subvisit_inputs
    args = (torch.tensor(rays), torch.tensor(tris), torch.tensor(lst), 8)
    a, b = t5.subvisit(*args, True), t5.subvisit(*args, False)
    assert not torch.equal(a, b)


# ---------------------------------------------------------- T1 cost variants

def _rects_at(width: int):
    """tests/test_torch_scene.py's 350 rects behind a width x width camera."""
    rng = np.random.default_rng(7)
    b = JaxBuilder()
    m = b.lambert([0.7, 0.7, 0.7])
    for _ in range(350):
        c = rng.uniform(-4, 4, 3)
        vx = rng.uniform(-0.4, 0.4, 3)
        vy = rng.uniform(-0.4, 0.4, 3)
        b.add_rect(c, vx, vy, m)
    return b.build(cam_pos=[0, 0, 10], cam_lookat=[0, 0, 0], width=width,
                   height=width)


@pytest.fixture(scope="module")
def cost_scenes():
    js = _rects_at(512)  # the tool's W
    return js, to_port(js)


@pytest.mark.parametrize("variant", ["floor", "stagea1", "stagea2",
                                     "compact1", "compact2", "fm2"])
def test_cluster_cost_matches_tool(cost_scenes, variant, monkeypatch):
    js, ps = cost_scenes
    mod = _load_tool("exp_kernel_cost", monkeypatch)
    monkeypatch.setattr(mod, "load_scene", lambda *a, **k: js)
    seen = []

    def timeit(f, *a, n=20):
        seen.append((np.asarray(f(*a)), [np.asarray(x) for x in a]))
        return 1.0

    monkeypatch.setattr(mod, "timeit", timeit)
    monkeypatch.setattr(sys, "argv", ["exp_kernel_cost.py", variant])
    mod.main()
    ((out_j, (rays, oct_)),) = seen
    assert out_j.shape == rays.shape == (1024, 256, 8)
    kind, n = t1.parse(variant)
    out_p, outi_p = t1.cluster_cost(kind, torch.tensor(rays),
                                    torch.tensor(oct_), ps.cl_bounds_oct, n)
    assert not outi_p.any()
    assert np.array_equal(_bits(out_p.numpy()), _bits(out_j))
    if kind == "stagea":
        assert (out_j[:, 0, 0] > 0).any()  # some block enters a box of word 0
        # the port's own rays are the tool's (make_eye_rays of either package)
        r_p, oct_p = t1.lab_rays(ps, 512)
        np.testing.assert_allclose(r_p.numpy(), rays, rtol=1e-5, atol=1e-6)
        assert np.array_equal(oct_p.numpy(), oct_)
    if kind == "compact":
        assert (out_j[:, 0, 0] > 0).any()


def test_cluster_cost_scan_ends_without_live_ray():
    """As B1's, the lab scan ends where no ray of the block is live: such a
    block has no bits; dead rays of a live block still set theirs (the
    tool's slab test has no liveness test of the ray)."""
    sc = t1.bench_scene(32, 32)
    rays, oct_ = t1.lab_rays(sc, 32)
    hit = t1.entered_positions(rays, oct_, sc.cl_bounds_oct)
    assert hit[0].any() and hit[1].any()
    rays[0, :, 7] = 0.0
    rays[1, 1:, 7] = 0.0
    dead = t1.entered_positions(rays, oct_, sc.cl_bounds_oct)
    assert not dead[0].any()
    assert torch.equal(dead[1:], hit[1:])
    out, _ = t1.cluster_cost("compact", rays, oct_, sc.cl_bounds_oct, 2)
    assert float(out[0].abs().max()) == 0.0
    assert float(out[1, 0, 0]) == 2 * int(hit[1].sum())


@pytest.fixture(scope="module")
def cost_adversarial():
    return t1.adversarial_inputs()


@pytest.mark.parametrize("name", t1.ADVERSARIAL)
def test_cluster_cost_adversarial_matches_tool(cost_scenes, cost_adversarial,
                                               name, monkeypatch):
    """t1.adversarial_inputs through the tool's stagea2 and compact2 kernels
    (each built by the tool's main() for a stand-in scene that carries the
    case's boxes, then run on the case's blocks) and the plain version: the
    words and counts equal on every block with a live ray; a block without
    one (the port's scan ends there, as B1's; the tool's kernel, whose rays
    are all active, has no such test) is 0 in the port."""
    js, _ = cost_scenes
    rays, oct_, cbl = cost_adversarial[name]
    mod = _load_tool("exp_kernel_cost", monkeypatch)
    stand_in = collections.namedtuple(
        "Scene", "camera cl_bounds_oct cl_tris cl_oct_perm")(
        js.camera, jnp.asarray(cbl.numpy()), js.cl_tris, js.cl_oct_perm)
    monkeypatch.setattr(mod, "load_scene", lambda *a, **k: stand_in)
    monkeypatch.setattr(mod, "timeit", lambda f, *a, n=20: 1.0)
    build = mod.build
    live = (rays[..., 7] > 0).any(dim=1).numpy()
    for variant in ("stagea2", "compact2"):
        kernels = []
        monkeypatch.setattr(mod, "build", lambda k, *a: kernels.append(k))
        monkeypatch.setattr(sys, "argv", ["exp_kernel_cost.py", variant])
        mod.main()
        out_j = np.asarray(build(kernels[0], rays.shape[0], cbl.shape[2],
                                 stand_in.cl_bounds_oct, js.cl_tris,
                                 js.cl_oct_perm)(jnp.asarray(rays.numpy()),
                                                 jnp.asarray(oct_.numpy())))
        kind, n = t1.parse(variant)
        out_p, outi_p = t1.cluster_cost(kind, rays, oct_, cbl, n)
        out_p = out_p.numpy()
        assert not outi_p.any()
        assert np.array_equal(_bits(out_p[live]), _bits(out_j[live]))
        assert not out_p[~live].any()
        assert (out_p[live, 0, 0] > 0).sum() >= 3
    if name == "mixed":
        assert live.tolist() == [False] + [True] * 7
        assert out_p[3, 0, 0] == 0.0  # NaN origins: no box entered


# ------------------------------------------- the port's entry points, on CPU

def test_lab_mains_run_plain_versions_on_cpu(capsys):
    """Each tool's main() with device="cpu" runs the plain versions, at a
    small size, and labels its times as the host's."""
    assert set(t7.main(device="cpu", r=64, n=1)) == {
        "taa", "onehot", "taa direct", "onehot direct"}
    assert all(r["ok"] for r in t6.main(device="cpu", n=1).values())
    assert set(t5.main(device="cpu", g=1, v=8, c=4, n=1)) == set(t5.VARIANTS)
    out = t1.main(device="cpu", w=32, n=1)
    assert set(out) == set(t1.ALL) | {"split"}
    assert abs(sum(out["split"].values()) - 1.0) < 1e-9
    printed = capsys.readouterr().out
    assert printed.count("host clock") >= 2 + 10 + 4 + len(t1.ALL)
    with pytest.raises(ValueError, match="variant"):
        t1.main("stagea", device="cpu", w=32)


def test_lab_wrappers_check_their_inputs():
    pool, idx = t7.inputs(16, 8, device="cpu")
    with pytest.raises(TypeError):
        t7.gather(pool, idx.to(torch.int64))
    x, xi = t6.inputs("cpu")
    with pytest.raises(ValueError):
        t6.prim(11, x, xi)
    rays, tris, lst = t5.inputs(1, 6, 4, device="cpu")
    with pytest.raises(ValueError, match="multiple of 4"):
        t5.subvisit(rays, tris, lst, 4)
    with pytest.raises(ValueError, match="multiple"):
        t5.subvisit(rays[:100], tris, lst[:4], 4)
    with pytest.raises(ValueError, match="profile"):
        t5.subvisit(rays, tris, lst[:4], 4,
                    profile=torch.zeros(len(t5.PROFILE), dtype=torch.int64))
    blocks = torch.zeros((4, 256, 8))
    with pytest.raises(ValueError, match="multiple of 3"):
        t1.cluster_cost("fm", blocks, torch.zeros(4, dtype=torch.int32),
                        torch.zeros((8, 8, 128)), 3)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t7.main(r=64)
