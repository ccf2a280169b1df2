"""Shading parity: the port's material fetch, BSDF and light sampling
against the JAX package's functions on the same random inputs (numpy,
seeded), over the tables of the five procedural golden scenes plus one
scene holding every light type and lobe SceneBuilder can make.

Both sides read the very same scene bytes (scene_from_arrays of the JAX
scene). Tolerance: rtol 1e-5, atol 1e-6 on floats (transcendentals and
reduction order differ by an ulp between XLA and PyTorch on the CPU);
integer and boolean outputs exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.golden_scenes as gs
from hydracore_tpu.bsdf import core as jcore
from hydracore_tpu.lights import sampling as jls
from hydracore_tpu.scene.procedural import SceneBuilder as JaxBuilder
from hydracore_tpu_torch.bsdf import core as tcore
from hydracore_tpu_torch.lights import sampling as tls
from tests.test_torch_scene import build_with, to_port

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
R = 2048


def all_lights_recipe():
    """Every light type and lobe the procedural builder makes."""
    b = gs.SceneBuilder()
    m = b.lambert([0.6, 0.6, 0.6])
    f32 = np.float32
    mats = [
        b.add_material(diff_color=np.array([0.5, 0.4, 0.3], f32), diff_rough=0.6),
        b.add_material(refl_color=np.array([0.7, 0.7, 0.7], f32), refl_dist=1,
                       refl_cospow=32.0, refl_gloss=0.7),
        b.add_material(refl_color=np.array([0.6, 0.5, 0.4], f32), refl_dist=3,
                       refl_alpha=0.3, refl_gloss=0.7, fresnel_on=1.0,
                       fresnel_ior=1.8),
        b.add_material(refl_color=np.array([0.8, 0.8, 0.8], f32), refl_dist=2,
                       refl_alpha=0.2, refl_aniso=0.6, refl_aniso_rot=0.1),
        b.add_material(transp_color=np.array([0.9, 0.9, 0.9], f32),
                       transp_gloss=0.7, transp_ior=1.4),
        b.add_material(transp_color=np.array([0.9, 0.8, 0.9], f32),
                       thin_walled=1),
        b.add_material(diff_color=np.array([0.3, 0.3, 0.3], f32),
                       transl_color=np.array([0.4, 0.5, 0.2], f32)),
    ]
    b.add_box_interior(2.0, m, *mats[:4])
    for k, mt in enumerate(mats[4:]):
        b.add_rect([-1.0 + k, -1.0, 0.5], [0.3, 0, 0], [0, 0.3, 0.1], mt)
    b.rect_light([0, 1.95, 0], 0.4, 0.4, [8.0, 8.0, 8.0])
    b.sphere_light([1.0, -1.0, 0.0], 0.25, [6.0, 3.0, 2.0])
    b.cylinder_light([-1.2, 0.0, -1.0], 0.5, 0.1, [2.0, 4.0, 6.0], n_seg=8)
    b.point_light([0.5, 1.5, 0.5], [3.0, 3.0, 3.0])
    b.add_light(ltype=1, pos=np.array([-0.5, 1.8, 0.0], f32),
                norm=np.array([0, -1, 0], f32),
                intensity=np.array([8.0, 8.0, 7.0], f32), cos_in=0.9, cos_out=0.6)
    b.add_light(ltype=2, norm=np.array([0.3, -0.9, 0.3], f32) / np.float32(1.0),
                intensity=np.array([0.5, 0.5, 0.5], f32))
    b.add_light(ltype=4, pos=np.array([0.0, 0.0, 1.99], f32),
                norm=np.array([0, 0, -1], f32), vx=np.array([0.3, 0, 0], f32),
                vy=np.array([0, 0.3, 0], f32), area=0.36, is_portal=1,
                intensity=np.array([1.0, 1.0, 1.0], f32))
    ml = b.mesh_light([5.0, 5.0, 1.0])
    em = b.emissive([5.0, 5.0, 1.0], light_id=ml)
    b.add_rect([0.0, -1.9, 1.0], [0.3, 0, 0], [0, 0, 0.3], em, light=ml)
    b.sky([0.2, 0.3, 0.4])
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=16, height=16)


SCENES = {**gs.SCENES, "all_lights": all_lights_recipe}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scenes(request):
    js = build_with(JaxBuilder, SCENES[request.param])
    return js, to_port(js)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1234)
    return dict(u=rng.random(R).astype(np.float32),
                uv=rng.random((R, 2)).astype(np.float32),
                rands=rng.random((R, 4)).astype(np.float32),
                n=_unit(rng, R), wo=_unit(rng, R), wi=_unit(rng, R),
                sp=rng.uniform(-1.9, 1.9, (R, 3)).astype(np.float32),
                mat_u=rng.random(R))


def _close(t, j, name):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    if j.dtype == bool or np.issubdtype(j.dtype, np.integer):
        assert np.array_equal(t, j), name
    else:
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL, err_msg=name)


def _materials(js, ps, x):
    M = ps.mat_attr.shape[0]
    mid = (x["mat_u"] * M).astype(np.int32)
    pj = jcore.fetch_material(js, jnp.asarray(mid), jnp.asarray(x["uv"]))
    pp = tcore.fetch_material(ps, torch.tensor(mid), torch.tensor(x["uv"]))
    return pj, pp


def test_fetch_material(scenes, inputs):
    js, ps = scenes
    pj, pp = _materials(js, ps, inputs)
    for f in tcore.MatParams._fields:
        a, b = getattr(pp, f), getattr(pj, f)
        # the normal-map fields are None in a scene without normal maps
        assert (a is None) == (b is None), f
        if a is not None:
            _close(a, b, f)


def test_eval_bsdf(scenes, inputs):
    js, ps = scenes
    x = inputs
    pj, pp = _materials(js, ps, x)
    assert tcore.scene_feats(ps) == jcore.scene_feats(js)
    fj, pdfj = jcore.eval_bsdf(pj, jnp.asarray(x["wo"]), jnp.asarray(x["wi"]),
                               jnp.asarray(x["n"]), jcore.scene_feats(js))
    fp, pdfp = tcore.eval_bsdf(pp, torch.tensor(x["wo"]), torch.tensor(x["wi"]),
                               torch.tensor(x["n"]), tcore.scene_feats(ps))
    _close(fp, fj, "f")
    _close(pdfp, pdfj, "pdf")


def test_sample_bsdf(scenes, inputs):
    js, ps = scenes
    x = inputs
    pj, pp = _materials(js, ps, x)
    sj = jcore.sample_bsdf(pj, jnp.asarray(x["wo"]), jnp.asarray(x["n"]),
                           jnp.asarray(x["rands"]), jcore.scene_feats(js))
    sp = tcore.sample_bsdf(pp, torch.tensor(x["wo"]), torch.tensor(x["n"]),
                           torch.tensor(x["rands"]), tcore.scene_feats(ps))
    for f in ("wi", "weight", "pdf", "is_specular", "is_transmission",
              "is_diff_trans"):
        _close(getattr(sp, f), getattr(sj, f), f)


def test_select_and_sample_light(scenes, inputs):
    js, ps = scenes
    x = inputs
    ij, prj = jls.select_light(js.lights, jnp.asarray(x["u"]))
    ip, prp = tls.select_light(ps.lights, torch.tensor(x["u"]))
    _close(ip, ij, "light index")
    _close(prp, prj, "pick prob")
    lj = jls.sample_light_rev(js, ij, jnp.asarray(x["rands"][:, :3]),
                              jnp.asarray(x["sp"]))
    lp = tls.sample_light_rev(ps, ip, torch.tensor(x["rands"][:, :3]),
                              torch.tensor(x["sp"]))
    for f in tls.LightSample._fields:
        _close(getattr(lp, f), getattr(lj, f), f)


def test_light_pdf_and_env(scenes, inputs):
    js, ps = scenes
    x = inputs
    L = ps.light_attr.shape[0]
    lrow = (x["mat_u"] * L).astype(np.int32)
    hit = x["sp"] + x["wi"]
    pj, kj = jls.light_eval_pdf_from_hit(
        js, jnp.asarray(lrow), jnp.asarray(x["sp"]), jnp.asarray(x["wi"]),
        jnp.asarray(hit), jnp.asarray(x["n"]), return_pick=True)
    pp, kp = tls.light_eval_pdf_from_hit(
        ps, torch.tensor(lrow), torch.tensor(x["sp"]), torch.tensor(x["wi"]),
        torch.tensor(hit), torch.tensor(x["n"]), return_pick=True)
    _close(pp, pj, "pdf")
    _close(kp, kj, "pick")
    _close(tls.env_radiance(ps, torch.tensor(x["wo"])),
           jls.env_radiance(js, jnp.asarray(x["wo"])), "env")


def test_sqrt_correctly_rounded():
    """utils/math3d.sqrt rounds like XLA's sqrt (correctly), bit for bit,
    where PyTorch's vectorized CPU sqrt may be one ulp off."""
    from hydracore_tpu_torch.utils.math3d import sqrt

    x = np.random.default_rng(9).random(1_000_000).astype(np.float32)
    exact = np.sqrt(x.astype(np.float64)).astype(np.float32)
    assert np.array_equal(sqrt(torch.tensor(x)).numpy(), exact)
    assert np.array_equal(np.asarray(jnp.sqrt(jnp.asarray(x))), exact)
