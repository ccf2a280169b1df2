"""Texture-fetch parity: the port's ops/texture.py, the textured material
fetch and the sky, back-plate and IES lookups against the JAX package on
the same inputs.

Tolerances:
  * fetches: rtol 1e-6 (atol 1e-12). The JAX package's scenes fetch from a
    quad heap (scene.texels_quad) whenever the heap is small; under clamp
    addressing with x0 < 0 that path returns the corner texel where the
    port's 4-corner fetch forms c*(1-fx) + c*fx, 1 ulp apart
    (test_quad_heap_ulp_inside_tolerance shows both);
  * material fields, normals, light and sky lookups: rtol 1e-5, atol
    1e-6 (transcendentals and the camera inverse differ by ulps); integer
    fields exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.textured_scenes as ts
from hydracore_tpu.bsdf import core as jcore
from hydracore_tpu.lights import sampling as jsamp
from hydracore_tpu.ops import texture as jtex
from hydracore_tpu.scene import textures as jtextures
from hydracore_tpu_torch.bsdf import core as tcore
from hydracore_tpu_torch.lights import sampling as tsamp
from hydracore_tpu_torch.ops import texture as ttex
from tests.test_torch_scene import to_port

torch.set_num_threads(1)

N = 4096
FETCH_TOL = dict(rtol=1e-6, atol=1e-12)
TOL = dict(rtol=1e-5, atol=1e-6)


def _heap(flags: int, matrix: bool):
    """Three textures (4x4, 8x16, 5x3) under `flags`, with an affine
    texcoord matrix or none; returns (texels, table, samplers, meta)."""
    st = jtextures.TextureStorage()
    m = np.array([[1.7, -0.4, 0, 0.3], [0.5, 2.2, 0, -0.6], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32) if matrix else None
    for k, (h, w) in enumerate(((4, 4), (8, 16), (5, 3))):
        st.add(ts.image(h, w, 40 + k), matrix=m, flags=flags)
    texels, table, samplers = st.finalize()
    meta = np.concatenate([table.view(np.float32), samplers], axis=1)
    return texels, table, samplers, meta


def _uv_rows(meta, seed, gamma):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    rows = meta[rng.integers(0, meta.shape[0], N)].copy()
    if gamma:
        rows[:, 10] = rng.choice([1.0, 2.2, 0.45], N).astype(np.float32)
    return uv, rows


@pytest.mark.parametrize("gamma", [False, True])
@pytest.mark.parametrize("matrix", [False, True])
@pytest.mark.parametrize("flags", [0, 1, 2, 3])
def test_sample_tex_row(flags, matrix, gamma):
    texels, _, _, meta = _heap(flags, matrix)
    uv, rows = _uv_rows(meta, 7 + flags, gamma)
    out_j = jtex.sample_tex_row(jnp.asarray(texels), jnp.asarray(rows),
                                jnp.asarray(uv), apply_gamma=gamma)
    out_p = ttex.sample_tex_row(torch.tensor(texels), torch.tensor(rows),
                                torch.tensor(uv), apply_gamma=gamma)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), **FETCH_TOL)


def test_quad_heap_ulp_inside_tolerance():
    """The JAX quad-heap fetch against the port's 4-corner fetch under
    clamp addressing: they differ (by an ulp) on some rays with x0 < 0 and
    agree within the fetch tolerance everywhere."""
    texels, table, _, meta = _heap(3, False)
    uv, rows = _uv_rows(meta, 3, False)
    uv[: N // 2] *= 0.02  # near texel 0: x0 = -1 under clamp
    quad = jtextures.build_quad_heap(texels, table)
    out_q = np.asarray(jtex.sample_tex_row_quad(
        jnp.asarray(quad), jnp.asarray(rows), jnp.asarray(uv)))
    out_p = ttex.sample_tex_row(torch.tensor(texels), torch.tensor(rows),
                                torch.tensor(uv)).numpy()
    assert (out_q != out_p).any()
    np.testing.assert_allclose(out_p, out_q, **FETCH_TOL)


@pytest.mark.parametrize("gamma", [False, True])
def test_sample_bilinear(gamma):
    texels, table, samplers, _ = _heap(2, True)
    samplers[:, 6] = [1.0, 2.2, 0.45, 1.8][: samplers.shape[0]]
    rng = np.random.default_rng(5)
    tid = rng.integers(0, table.shape[0], N).astype(np.int32)
    uv = rng.uniform(-1.0, 2.0, (N, 2)).astype(np.float32)
    for smp in (None, samplers):
        out_j = jtex.sample_bilinear(
            jnp.asarray(texels), jnp.asarray(table), jnp.asarray(tid),
            jnp.asarray(uv), None if smp is None else jnp.asarray(smp), gamma)
        out_p = ttex.sample_bilinear(
            torch.tensor(texels), torch.tensor(table), torch.tensor(tid),
            torch.tensor(uv), None if smp is None else torch.tensor(smp),
            gamma)
        np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j),
                                   **FETCH_TOL)


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name in ("surfaces", "sky_tree"):
        js = ts.RECIPES[name]()
        out[name] = (js, to_port(js))
    return out


def test_tex_fetch_scene(scenes):
    """tex_fetch by slot through a scene's tex_meta (the JAX scene fetches
    from its quad heap) and the stacked batch equal to single fetches."""
    js, ps = scenes["surfaces"]
    assert js.texels_quad is not None
    rng = np.random.default_rng(9)
    tid = rng.integers(0, ps.tex_meta.shape[0], N).astype(np.int32)
    uv = rng.uniform(-1.0, 2.0, (N, 2)).astype(np.float32)
    out_j = jtex.tex_fetch(js, jnp.asarray(tid), jnp.asarray(uv))
    out_p = ttex.tex_fetch(ps, torch.tensor(tid), torch.tensor(uv))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), **FETCH_TOL)
    rows = [ps.tex_meta[torch.tensor(rng.integers(0, ps.tex_meta.shape[0], N))]
            for _ in range(3)]
    batch = ttex.tex_fetch_rows_batch(ps, rows, torch.tensor(uv))
    for r, b in zip(rows, batch):
        assert torch.equal(b, ttex.tex_fetch_row(ps, r, torch.tensor(uv)))


def _close(t, j, name):
    j = np.asarray(j)
    t = t.numpy()
    if j.dtype == bool or np.issubdtype(j.dtype, np.integer):
        assert np.array_equal(t, j), name
    else:
        np.testing.assert_allclose(t, j, err_msg=name, **TOL)


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("name", ["surfaces", "sky_tree"])
def test_fetch_material_textured(scenes, name):
    """Every field of the textured fetch (one-level blends lerped in
    'surfaces', the two-level tree walked on u_blend in 'sky_tree'), and
    the normal map applied to it."""
    js, ps = scenes[name]
    rng = np.random.default_rng(13)
    M = ps.mat_attr.shape[0]
    x = dict(mid=rng.integers(0, M, N).astype(np.int32),
             uv=rng.uniform(-0.5, 1.5, (N, 2)).astype(np.float32),
             pos=rng.uniform(-2, 2, (N, 3)).astype(np.float32),
             n=_unit(rng, N), wo=_unit(rng, N), tang=_unit(rng, N),
             ub=rng.random(N).astype(np.float32))
    j = {k: jnp.asarray(v) for k, v in x.items()}
    p = {k: torch.tensor(v) for k, v in x.items()}
    pj = jcore.fetch_material(js, j["mid"], j["uv"], j["pos"], j["n"],
                              wo=j["wo"], u_blend=j["ub"])
    pp = tcore.fetch_material(ps, p["mid"], p["uv"], p["pos"], p["n"],
                              wo=p["wo"], u_blend=p["ub"])
    for f in tcore.MatParams._fields:
        a, b = getattr(pp, f), getattr(pj, f)
        if f == "bump_rgb":  # the JAX package fetches it in apply_bump
            assert b is None and (a is not None) == js.settings.has_bump
            continue
        assert (a is None) == (b is None), f
        if a is not None:
            _close(a, b, f)
    nj = jcore.apply_bump(js, pj, j["n"], j["tang"], j["uv"])
    np_ = tcore.apply_bump(ps, pp, p["n"], p["tang"], p["uv"])
    _close(np_, nj, "bumped normal")
    if js.settings.has_bump:
        assert not np.allclose(np.asarray(nj), x["n"], atol=1e-3)


def test_ies_lookup(scenes):
    """NEE samples of the IES point and spot lights."""
    js, ps = scenes["surfaces"]
    assert js.settings.has_ies
    rng = np.random.default_rng(17)
    lidx = rng.integers(0, ps.light_attr.shape[0], N).astype(np.int32)
    rn = rng.random((N, 3)).astype(np.float32)
    sp = rng.uniform(-1.9, 1.9, (N, 3)).astype(np.float32)
    lj = jsamp.sample_light_rev(js, jnp.asarray(lidx), jnp.asarray(rn),
                                jnp.asarray(sp))
    lp = tsamp.sample_light_rev(ps, torch.tensor(lidx), torch.tensor(rn),
                                torch.tensor(sp))
    for f in ("dir", "dist", "radiance", "pdf_w", "is_delta"):
        _close(getattr(lp, f), getattr(lj, f), f)


@pytest.mark.parametrize("mode", [2.0, 1.0])
def test_sky_and_back_plate(scenes, mode):
    """env_radiance through the sky image, and env_back_radiance in the
    camera-projected (2) and the spherical (1) mode."""
    js, ps = scenes["sky_tree"]
    eb = np.asarray(js.env_back).copy()
    eb[1] = mode
    js = js.replace(env_back=eb)
    ps = dataclasses.replace(ps, env_back=torch.tensor(eb))
    d = jnp.asarray(_unit(np.random.default_rng(19), N))
    dt = torch.tensor(np.asarray(d))
    _close(tsamp.env_radiance(ps, dt), jsamp.env_radiance(js, d), "sky")
    _close(tsamp.env_back_radiance(ps, dt), jsamp.env_back_radiance(js, d),
           "back plate")
