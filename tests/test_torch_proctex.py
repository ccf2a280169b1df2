"""Procedural textures: the port's ops/proctex.py against the JAX
package's, and statefile proc textures through both packages' assemble.

Tolerances: falloff, hexaplanar (texture fetches, 1 ulp apart where the
JAX package takes its quad heap), ao_dirt and checker at rtol 1e-6;
perlin_marble within 1e-4 on >= 99% of points with its hash replaced by a
well-conditioned one in both packages (test_examples_match_jax says why
the hash itself agrees only where the arithmetic does). The registries
are per package: each test registers the same functions in the same order
in both and clears both after. A texture that ships its C source is
compiled by ops/proctex_c in both packages (tests/test_torch_proctex_c.py
holds the two translators together), falling back to the stdlib match, with
a warning, only when the source is outside the translator's subset.
"""
import dataclasses
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.textured_scenes as ts
from hydracore_tpu.integrators import pt as jpt
from hydracore_tpu.ops import proctex as jproc
from hydracore_tpu.scene import scene as jscene
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.ops import proctex as pproc
from hydracore_tpu_torch.scene import scene as pscene
from tests.test_torch_assemble import JAX, PORT
from tests.test_torch_scene import (_assert_same_leaves, jax_leaves,
                                    jax_settings, to_port)

torch.set_num_threads(1)

RTOL = 1e-6


@pytest.fixture
def registries():
    """Both registries empty before and after."""
    jproc.clear_registry()
    pproc.clear_registry()
    try:
        yield
    finally:
        jproc.clear_registry()
        pproc.clear_registry()


def _inputs(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    pos = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    args = rng.random((n, 8)).astype(np.float32)
    ao = rng.uniform(-0.2, 1.2, n).astype(np.float32)
    return uv, pos, nrm, wo, args, ao


@pytest.fixture(scope="module")
def tex_scenes():
    """A JAX scene with a texture heap (tests/textured_scenes.py:surfaces)
    and the port's copy of it, for sample2d."""
    js = ts.surfaces()
    return js, to_port(js)


def _hexa_args(args, n_tex):
    a = args.copy()
    a[:, 0:6] = np.floor(args[:, 0:6] * n_tex)  # texture slots 0..n_tex-1
    a[:, 6] = args[:, 6] * 8.0
    a[:, 7] = 0.2 + args[:, 7]
    return a


@pytest.mark.parametrize("name", ["falloff", "hexaplanar", "ao_dirt"])
def test_stdlib_matches_jax(tex_scenes, name):
    js, ps = tex_scenes
    uv, pos, nrm, wo, args, ao = _inputs()
    if name == "hexaplanar":
        args = _hexa_args(args, ps.tex_meta.shape[0])
    fj = getattr(jproc, name)
    fp = getattr(pproc, name)

    def s2d_j(slot, st):
        from hydracore_tpu.ops.texture import tex_fetch
        return tex_fetch(js, slot.astype(jnp.int32), st)

    def s2d_p(slot, st):
        from hydracore_tpu_torch.ops.texture import tex_fetch
        return tex_fetch(ps, slot.to(torch.int32), st)

    extra = (ao,) if name == "ao_dirt" else ()
    out_j = np.asarray(fj(*(jnp.asarray(x) for x in (uv, pos, nrm, wo, args)),
                          s2d_j, *(jnp.asarray(x) for x in extra)))
    out_p = fp(*(torch.tensor(x) for x in (uv, pos, nrm, wo, args)), s2d_p,
               *(torch.tensor(x) for x in extra)).numpy()
    assert out_p.shape == (uv.shape[0], 3) and np.isfinite(out_p).all()
    np.testing.assert_allclose(out_p, out_j, rtol=RTOL, atol=1e-7)
    assert out_p.std() > 0.01


def _smooth_hash_j(p):
    return jnp.stack([0.5 + 0.5 * jnp.sin(p[..., 0] * 0.37 + p[..., 1] * 0.61
                                          + p[..., 2] * 0.23)] * 3, -1)


def _smooth_hash_p(p):
    return torch.stack([0.5 + 0.5 * torch.sin(p[..., 0] * 0.37 + p[..., 1] * 0.61
                                              + p[..., 2] * 0.23)] * 3, -1)


def test_examples_match_jax(monkeypatch):
    """checker bit for bit. _hash3 is frac(sin(x) * 43758.5453): an ulp of
    x or of sin(x) moves it by 1e-3 to 1e-2, and XLA:CPU forms the third
    column of p @ M^T with an FMA (the first two without) and rounds sin
    differently from PyTorch on about 5% of inputs, so the two hashes are
    equal only where their arithmetic is: on most points, not all. The
    structure of value_noise3 and perlin_marble (smoothstep weights, eight
    corners, three octaves, the sine) is held with a well-conditioned hash
    put in both packages' place: >= 99% of points within 1e-4."""
    uv, pos, nrm, _, _, _ = _inputs()
    np.testing.assert_array_equal(
        pproc.checker(*(torch.tensor(x) for x in (uv, pos, nrm))).numpy(),
        np.asarray(jproc.checker(*(jnp.asarray(x) for x in (uv, pos, nrm)))))
    h_p = pproc._hash3(torch.tensor(pos)).numpy()
    h_j = np.asarray(jproc._hash3(jnp.asarray(pos)))
    assert 0.0 <= h_p.min() and h_p.max() < 1.0
    assert (h_p == h_j).mean() >= 0.75
    m_p = pproc.perlin_marble(*(torch.tensor(x) for x in (uv, pos, nrm))).numpy()
    assert 0.0 <= m_p.min() and m_p.max() <= 1.0 and m_p.std() > 0.1
    monkeypatch.setattr(jproc, "_hash3", _smooth_hash_j)
    monkeypatch.setattr(pproc, "_hash3", _smooth_hash_p)
    m_p = pproc.perlin_marble(*(torch.tensor(x) for x in (uv, pos, nrm))).numpy()
    m_j = np.asarray(jproc.perlin_marble(*(jnp.asarray(x)
                                           for x in (uv, pos, nrm))))
    assert (np.abs(m_p - m_j).max(-1) <= 1e-4).mean() >= 0.99
    assert m_p.std() > 0.1


def test_eval_selects_by_id(registries, tex_scenes):
    """3-, 6- and 7-parameter functions (the arity picks the call), ids
    -1 (white) to 3, through eval_proc_tex with the scene's heap."""
    js, ps = tex_scenes
    fns = ("checker", "falloff", "ao_dirt", "hexaplanar")
    for f in fns:
        assert jproc.register_proc_tex(getattr(jproc, f)) \
            == pproc.register_proc_tex(getattr(pproc, f))
    assert [n for _, n in pproc._REGISTRY] == [3, 6, 7, 6]
    uv, pos, nrm, wo, args, ao = _inputs(seed=4)
    args = _hexa_args(args, ps.tex_meta.shape[0])
    ids = np.random.default_rng(9).integers(-1, len(fns), uv.shape[0])
    ids = ids.astype(np.int32)
    out_j = np.asarray(jproc.eval_proc_tex(
        *(jnp.asarray(x) for x in (ids, uv, pos, nrm, wo, args)), scene=js,
        ao=jnp.asarray(ao)))
    out_p = pproc.eval_proc_tex(
        *(torch.tensor(x) for x in (ids, uv, pos, nrm, wo, args)), scene=ps,
        ao=torch.tensor(ao)).numpy()
    np.testing.assert_allclose(out_p, out_j, rtol=RTOL, atol=1e-7)
    assert (out_p[ids < 0] == 1.0).all()
    # without a registry every id is white
    pproc.clear_registry()
    white = pproc.eval_proc_tex(torch.tensor(ids), torch.tensor(uv),
                                torch.tensor(pos), torch.tensor(nrm))
    assert (white == 1.0).all()


def proc_desc(pkg, lib_dir, size: int = 24, source: bool = False):
    """A SceneDesc whose three image textures are written to lib_dir and
    whose type="proc" textures a material binds by texref_proc: falloff
    on the back wall (by name), hexaplanar over the three images on the
    left wall (by its prtexN_ main symbol), ao_dirt with an 'up' AO
    hemisphere of length 0.8 on the floor, and 'noise', which no stdlib
    entry matches (a warning, the wall renders without it). With `source`
    the falloff texture ships a .c file in the library."""
    sf, vs = pkg
    textures = {}
    for tid, seed in ((1, 31), (2, 32), (3, 33)):
        data = ts._image4ub(ts.image(8, 8, seed))
        name = f"tri{tid}.image4ub"
        with open(os.path.join(lib_dir, name), "wb") as f:
            f.write(data)
        textures[tid] = sf.TextureDesc(id=tid, name=name, loc=name, offset=0,
                                       bytesize=len(data))
    loc = None
    if source:
        loc = "falloff.c"
        with open(os.path.join(lib_dir, loc), "w") as f:
            f.write("float4 prtex1_main(const SurfaceInfo* sHit) "
                    "{ return make_float4(1, 1, 1, 1); }\n")
    textures[4] = sf.TextureDesc(id=4, name="falloff", loc=loc, offset=0,
                                 bytesize=0, proc_name="falloff")
    textures[5] = sf.TextureDesc(id=5, name="triplanar", loc=None, offset=0,
                                 bytesize=0, proc_name="triplanar",
                                 proc_main="prtex2_hexaplanar")
    textures[6] = sf.TextureDesc(id=6, name="dirt", loc=None, offset=0,
                                 bytesize=0, proc_name="dirt", ao_type=1,
                                 ao_length=0.8)
    textures[7] = sf.TextureDesc(id=7, name="noise", loc=None, offset=0,
                                 bytesize=0, proc_name="noise")

    def proc(tid, args):
        a = "".join(f'<arg type="{t}" val="{v}"/>' for t, v in args)
        return f'<texture id="{tid}" type="texref_proc">{a}</texture>'

    def mat(mid, color, tex=""):
        return (f'<material id="{mid}" type="hydra_material"><diffuse '
                f'brdf_type="lambert"><color val="{color}"/>{tex}</diffuse>'
                '</material>')

    import xml.etree.ElementTree as ET
    xml = {
        0: mat(0, "0.9 0.9 0.9", proc(6, [("float3", "0.05 0.04 0.03"),
                                          ("float3", "0.8 0.75 0.7")])),
        1: mat(1, "1 1 1", proc(4, [("float3", "0.9 0.2 0.1"),
                                    ("float3", "0.1 0.3 0.9")])),
        2: mat(2, "1 1 1", proc(5, [("sampler2D", "1"), ("sampler2D", "2"),
                                    ("sampler2D", "3"), ("sampler2D", "3"),
                                    ("sampler2D", "2"), ("sampler2D", "1"),
                                    ("float", "4.0"), ("float", "0.7")])),
        3: mat(3, "0.5 0.5 0.6", proc(7, [("float", "1.0")])),
        4: ('<material id="4" type="hydra_material" light_id="0"><emission>'
            '<color val="10 10 10"/></emission></material>'),
    }
    light = ('<light id="0" type="area" shape="rect"><size half_length="0.5" '
             'half_width="0.5"/><intensity><color val="10 10 10"/></intensity>'
             '</light>')
    meshes = {
        0: ts.rect_arrays([0, -1, 0], [2, 0, 0], [0, 0, -2], 0),
        1: ts.rect_arrays([0, 0.5, -2], [2, 0, 0], [0, 1.5, 0], 1),
        2: ts.rect_arrays([-2, 0.5, 0], [0, 0, 2], [0, 1.5, 0], 2),
        3: ts.rect_arrays([0.6, -0.4, 0.2], [0.5, 0, 0.3], [0, 0.6, 0], 3),
        4: ts.rect_arrays([0, 0, 0], [0.5, 0, 0], [0, 0, 0.5], 4),
    }
    m_light = np.eye(4, dtype=np.float32)
    m_light[:3, 3] = [0, 1.9, 0]
    eye = np.eye(4, dtype=np.float32)
    instances = [sf.InstanceDesc(mesh_id=k, matrix=eye) for k in range(4)]
    instances.append(sf.InstanceDesc(mesh_id=4, matrix=m_light, light_id=0,
                                     linst_id=0))
    cam = sf.CameraDesc()
    cam.position = np.array([0.6, 0.4, 4.5], np.float32)
    cam.look_at = np.array([-0.3, -0.2, 0], np.float32)
    return sf.SceneDesc(
        lib_dir=str(lib_dir), textures=textures,
        materials={k: ET.fromstring(v) for k, v in xml.items()},
        lights={0: ET.fromstring(light)}, camera=cam,
        settings=sf.RenderSettings(width=size, height=size, trace_depth=3),
        meshes={k: vs.MeshData(**v) for k, v in meshes.items()},
        mesh_light_id={}, instances=instances,
        light_instances=[sf.LightInstanceDesc(light_id=0, matrix=m_light)])


def test_statefile_proc_textures(registries, tmp_path):
    """Both packages bind the same stdlib functions to the same ids and
    assemble the same leaves, bit for bit; 'noise' warns in both and stays
    unbound; the scene renders as the JAX package renders it (cluster
    route, 24x24, 4 passes: the rule of tests/test_torch_pt.py)."""
    with pytest.warns(UserWarning, match="noise"):
        js = jscene.assemble(proc_desc(JAX, tmp_path))
    with pytest.warns(UserWarning, match="noise"):
        ps = pscene.assemble(proc_desc(PORT, tmp_path))
    _assert_same_leaves(jax_leaves(js), pscene.scene_leaves(ps))
    assert jax_settings(js) == dataclasses.asdict(ps.settings)
    st = ps.settings
    assert st.has_proc_tex and st.has_proc_ao
    assert [f.__name__ for f, _ in jproc._REGISTRY] \
        == [f.__name__ for f, _ in pproc._REGISTRY] \
        == ["falloff", "hexaplanar", "ao_dirt"]  # in texture id order
    mt = ps.materials
    assert mt.diff_proc.tolist()[:4] == [2, 0, 1, -1]
    assert mt.ao_type.tolist()[:4] == [1, 0, 0, 0]
    assert float(mt.ao_length[0]) == pytest.approx(0.8)
    assert mt.proc_args[2, 6:8].tolist() == pytest.approx([4.0, 0.7])
    # a second assembly reuses the registered ids
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pscene.assemble(proc_desc(PORT, tmp_path))
    assert pproc.num_proc_tex() == 3

    img_j, rays_j = jpt.render_passes(js, jnp.uint32(0), jnp.uint32(777),
                                      n_pass=4, max_depth=3)
    img_j = np.asarray(img_j) / 4
    img_p, rays_p = tpt.render_passes(to_port(js, traversal="cluster"), 0,
                                      777, n_pass=4, max_depth=3, device="cpu")
    img_p = img_p.numpy() / 4
    assert np.isfinite(img_p).all() and img_p.mean() > 0.01
    assert (np.abs(img_p - img_j).max(-1) <= 1e-3).mean() >= 0.99
    assert abs(int(rays_p) - float(rays_j)) <= 1e-3 * float(rays_j)


def test_source_raises(registries, tmp_path):
    """A texture whose .c source lies in the library is compiled
    (ops/proctex_c) and registered with arity 7 ahead of any stdlib match,
    in both packages alike; a source outside the translator's subset
    raises ProcTexCompileError, on which register_stdlib_instance warns and
    binds the stdlib match; "float4 prtex1_main() { }" registers (it raises
    only when evaluated). build_material_table binds the library's source
    for the falloff texture: the same ids and leaves in both packages."""
    from hydracore_tpu.ops import proctex_c as jpc
    from hydracore_tpu_torch.ops import proctex_c as ppc

    good = ("float4 prtex1_main(const SurfaceInfo* sHit) "
            "{ return make_float4(0.5f, 1, 1, 1); }")
    bad = "float4 prtex1_main(const SurfaceInfo* sHit) { while (1) {} }"
    for proc, pc in ((jproc, jpc), (pproc, ppc)):
        i = proc.register_stdlib_instance("falloff", "good.c", source=good)
        assert i == 0 and proc._REGISTRY[0][1] == 7
        assert proc._REGISTRY[0][0] is not proc.falloff
        with pytest.raises(pc.ProcTexCompileError):
            proc.register_source_instance(bad)
        with pytest.warns(UserWarning, match="falling back to the stdlib"):
            k = proc.register_stdlib_instance("falloff", "bad.c", source=bad)
        assert k == 1 and proc._REGISTRY[k][0] is proc.falloff
        e = proc.register_source_instance("float4 prtex1_main() { }")
        assert e == proc.num_proc_tex() - 1 == 2
        assert proc.register_stdlib_instance("falloff", "good.c",
                                             source=good) == 0
        proc.clear_registry()

    with pytest.warns(UserWarning, match="noise"):
        js = jscene.assemble(proc_desc(JAX, tmp_path, source=True))
    with pytest.warns(UserWarning, match="noise"):
        ps = pscene.assemble(proc_desc(PORT, tmp_path, source=True))
    _assert_same_leaves(jax_leaves(js), pscene.scene_leaves(ps))
    assert [f.__name__ for f, _ in jproc._REGISTRY] \
        == [f.__name__ for f, _ in pproc._REGISTRY] \
        == ["proctex_prtex1_main", "hexaplanar", "ao_dirt"]
    assert ps.materials.diff_proc.tolist()[:4] == [2, 0, 1, -1]
