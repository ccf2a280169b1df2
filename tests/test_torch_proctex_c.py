"""The procedural-texture C translator: the port's ops/proctex_c.py against
the JAX package's, and a statefile texture whose .c source lies in the
library through both packages' assemble.

Every source is inline (no reference scene): each goes through both
translators on the same seeded inputs and must agree at atol 1e-5, as
tests/test_proctex_c.py holds the JAX translator to its stdlib. A source
outside the subset raises ProcTexCompileError in both; a shader that
returns on no path compiles in both and raises only when evaluated. The
statefile scene renders at the rule of tests/test_torch_pt.py (>= 99% of
pixels within 1e-3 of the JAX render), with the same registry ids in both
packages (the registries are per package: both cleared before and after).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore_tpu.integrators import pt as jpt
from hydracore_tpu.ops import proctex as jproc
from hydracore_tpu.ops import proctex_c as jpc
from hydracore_tpu.scene import scene as jscene
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.ops import proctex as pproc
from hydracore_tpu_torch.ops import proctex_c as ppc
from hydracore_tpu_torch.scene import scene as pscene
from tests.test_proctex_c import NOVEL_SRC
from tests.test_torch_assemble import JAX, PORT
from tests.test_torch_proctex import proc_desc
from tests.test_torch_scene import (_assert_same_leaves, jax_leaves,
                                    jax_settings, to_port)

torch.set_num_threads(1)

ATOL = 1e-5

LOOPS_SRC = r"""
float4 prtex2_main(const SurfaceInfo* sHit, float3 base, float k,
                   _PROCTEXTAILTAG_)
{
  float3 p = readAttr_WorldPos(sHit);
  float acc = 0.0f;
  for (int i = 0; i <= 3; ++i) {
    for (int j = 1; j < 3; j++)
      acc += sin(p.x * (1.0f + i) + p.y * j) * k;
  }
  float3 c = base;
  c *= 0.5f + 0.1f * acc;
  return make_float4(c.x, c.y, c.z, acc);
}
"""

SWIZZLE_SRC = r"""
float4 prtex3_main(const SurfaceInfo* sHit, float3 a, float2 b,
                   _PROCTEXTAILTAG_)
{
  float3 p = readAttr_WorldPos(sHit);
  float3 c = a.zyx * 0.5f + p.xxy;
  float2 q = b.yx;
  c.x = q.x + c.z;
  c.y *= 2.0f;
  c.z -= q.y;
  if (p.y > 0.0f) c.x = 0.25f;
  float4 r = make_float4(c.x, c.y, c.z, 1.0f);
  r.w = length(c.xy);
  float2 s = make_float2(r.w, p.z);
  return make_float4(r.x + s.y, r.y, r.z, s.x);
}
"""

MATH_SRC = r"""
float4 prtex4_main(const SurfaceInfo* sHit, float k, _PROCTEXTAILTAG_)
{
  float3 p = readAttr_WorldPos(sHit);
  float m = fmod(p.x * 3.0f, 1.0f);
  float r = p.y % 0.7f;
  float s = smoothstep(-1.0f, 1.5f, p.z);
  float w = pow(p.x, 2.5f) + pow(k, 0.5f);
  float g = m < 0.0f ? -m : m * 2.0f;
  if (p.z < -1.5f) return make_float4(s, 0.0f, 0.0f, 1.0f);
  float l = log(p.x) + sqrt(p.y) + sign(p.z) + fract(p.y * 2.0f);
  if (!(p.x > 1.0f) && p.y > 1.0f || k > 0.9f)
    return make_float4(l, w, 0.5f, 0.0f);
  return make_float4(g + r, w, s + 0.1f * l, step(0.5f, k));
}
"""

TEXTURE_SRC = r"""
float4 prtex6_main(const SurfaceInfo* sHit, sampler2D tex, float scale,
                   _PROCTEXTAILTAG_)
{
  float2 uv = readAttr_TexCoord0(sHit);
  float4 t = texture2D(tex, uv * scale, 0);
  float3 n = readAttr_ShadeNorm(sHit);
  return make_float4(t.x, t.y * fabs(n.y), t.z, t.w);
}
"""

AO_SRC = r"""
float4 prtex7_main(const SurfaceInfo* sHit, float3 dirt, float3 clean,
                   _PROCTEXTAILTAG_)
{
  float ao = readAttr_AO(sHit);
  float3 t = readAttr_Tangent(sHit);
  float3 bt = readAttr_Bitangent(sHit);
  float3 c = mix(dirt, clean, clamp(ao, 0.0f, 1.0f));
  return make_float4(c.x + 0.01f * t.x, c.y + 0.01f * bt.y, c.z, ao);
}
"""

HELPER_SRC = r"""
float3 prtex8_tint(float3 c, float k) { if (k > 0.5f) return c * k; return c; }
float prtex8_lum(float3 c) { return dot(c, make_float3(0.3f, 0.59f, 0.11f)); }

float4 prtex8_main(const SurfaceInfo* sHit, float3 c, float k,
                   _PROCTEXTAILTAG_)
{
  float3 t = prtex8_tint(c, k);
  float3 v = normalize(cross(readAttr_ShadeNorm(sHit), hr_viewVectorHack));
  float a = atan2(v.y, v.x) / M_PI;
  return make_float4(t.x, prtex8_lum(t), v.z, (float)a);
}
"""

CASES = {
    "control_flow": (NOVEL_SRC, [("cA", "float3", 0, 3),
                                 ("cB", "float3", 3, 3),
                                 ("freq", "float", 6, 1)]),
    "for_loops": (LOOPS_SRC, None),
    "swizzle_member": (SWIZZLE_SRC, None),
    "ternary_return_fmod_pow": (MATH_SRC, None),
    "texture2D": (TEXTURE_SRC, None),
    "readAttr_AO": (AO_SRC, None),
    "helper": (HELPER_SRC, None),
}


def _inputs(R=256, seed=7):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(0, 1, (R, 2)).astype(np.float32)
    pos = rng.uniform(-2, 2, (R, 3)).astype(np.float32)
    nrm = rng.normal(size=(R, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    wo = rng.normal(size=(R, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    args = rng.uniform(0, 1, (R, 8)).astype(np.float32)
    ao = rng.uniform(-0.2, 1.2, R).astype(np.float32)
    return uv, pos, nrm, wo, args, ao


def _s2d_j(slot, st):
    return jnp.concatenate([st, slot[:, None] * 0.25,
                            jnp.ones_like(st[:, :1])], axis=1)


def _s2d_p(slot, st):
    return torch.cat([st, slot[:, None] * 0.25, torch.ones_like(st[:, :1])],
                     dim=1)


def _run_both(src, gen_args, main=None):
    uv, pos, nrm, wo, args, ao = _inputs()
    fj = jpc.compile_proc_tex(src, main=main, gen_args=gen_args)
    fp = ppc.compile_proc_tex(src, main=main, gen_args=gen_args)
    out_j = fj(*(jnp.asarray(x) for x in (uv, pos, nrm, wo, args)), _s2d_j,
               jnp.asarray(ao))
    out_p = fp(*(torch.tensor(x) for x in (uv, pos, nrm, wo, args)), _s2d_p,
               torch.tensor(ao))
    return np.asarray(out_j), out_p.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_translator_matches_jax(name):
    src, gen_args = CASES[name]
    out_j, out_p = _run_both(src, gen_args)
    assert out_p.shape == out_j.shape == (256, 4)
    assert np.isfinite(out_p).all()
    np.testing.assert_allclose(out_p, out_j, rtol=0, atol=ATOL)
    assert out_p.std() > 0.01


def test_member_assign_builds_new_values():
    """A member assignment into a splatted value (one lane broadcast to
    every lane) or into a value another name holds changes that name
    alone, and only the live lanes of a predicated branch."""
    src = r"""
float4 prtex9_main(const SurfaceInfo* sHit, float k, _PROCTEXTAILTAG_)
{
  float3 p = readAttr_WorldPos(sHit);
  float3 a = make_float3(k);
  float3 b = a;
  b.y = p.x;
  if (p.y > 0.0f) { a.z = 2.0f; }
  return make_float4(a.z, b.x, b.y, a.y);
}
"""
    out_j, out_p = _run_both(src, None)
    np.testing.assert_allclose(out_p, out_j, rtol=0, atol=ATOL)
    _, pos, _, _, args, _ = _inputs()
    np.testing.assert_array_equal(out_p[:, 0],
                                  np.where(pos[:, 1] > 0, 2.0, args[:, 0]))
    np.testing.assert_array_equal(out_p[:, 2], pos[:, 0])
    np.testing.assert_array_equal(out_p[:, 3], args[:, 0])


def test_untaken_side_keeps_nan_out():
    """Both sides of a predicated if/else and of ?: are evaluated; the
    side not taken (here a division by zero) must not reach the result."""
    src = r"""
float4 prtex9_main(const SurfaceInfo* sHit, float k, _PROCTEXTAILTAG_)
{
  float3 p = readAttr_WorldPos(sHit);
  float z = p.x * 0.0f;
  float v = 1.0f;
  if (p.y > 5.0f) { v = 0.0f / z; } else { v = p.y; }
  float u = p.z > 5.0f ? 1.0f / z : p.z;
  return make_float4(v, u, k, 1.0f);
}
"""
    out_j, out_p = _run_both(src, None)
    assert np.isfinite(out_p).all() and np.isfinite(out_j).all()
    np.testing.assert_allclose(out_p, out_j, rtol=0, atol=ATOL)


@pytest.mark.parametrize("src", [
    "float4 m(const SurfaceInfo* s){ while(1){} }",
    "float4 prtex1_main(const SurfaceInfo* s) { int x[4]; return x; }",
    "float4 prtex1_main(const SurfaceInfo* s) { for (int i = 0; i < 99; i++) {} }",
    "double prtex1_main() { return 1; }",
    "float4 prtex1_main() { return 1 $ 2; }",
])
def test_outside_subset_raises(src):
    for mod in (jpc, ppc):
        with pytest.raises(mod.ProcTexCompileError):
            mod.compile_proc_tex(src, main="m")
    assert issubclass(ppc.ProcTexCompileError, ValueError)


@pytest.mark.parametrize("src", [
    "float4 prtex1_main() { }",
    "float h(float x) { if (x > 0.0f) { } }\n"
    "float4 prtex1_main(const SurfaceInfo* s) { return make_float4(h(1.0f)); }",
    "float4 prtex1_main(const SurfaceInfo* s) { return foo(1.0f); }",
])
def test_raises_only_when_evaluated(src):
    """No return, a helper without one, an unknown function: each compiles
    and raises ProcTexCompileError when the shader runs, in both."""
    uv, pos, nrm, wo, args, ao = _inputs(R=8)
    fj = jpc.compile_proc_tex(src)
    fp = ppc.compile_proc_tex(src)
    with pytest.raises(jpc.ProcTexCompileError):
        fj(*(jnp.asarray(x) for x in (uv, pos, nrm, wo, args)), _s2d_j)
    with pytest.raises(ppc.ProcTexCompileError):
        fp(*(torch.tensor(x) for x in (uv, pos, nrm, wo, args)), _s2d_p)


# the stdlib falloff's arithmetic (ops/proctex.py:falloff) as C source
FALLOFF_C = r"""
float4 prtex1_main(const SurfaceInfo* sHit, float3 color1, float3 color2,
                   _PROCTEXTAILTAG_)
{
  const float3 n = readAttr_ShadeNorm(sHit);
  const float cos_a = fabs(dot(n, hr_viewVectorHack));
  const float3 c = color1 * (1.0f - cos_a) + color2 * cos_a;
  return make_float4(c.x, c.y, c.z, 1.0f);
}
"""


@pytest.fixture
def registries():
    jproc.clear_registry()
    pproc.clear_registry()
    try:
        yield
    finally:
        jproc.clear_registry()
        pproc.clear_registry()


def test_statefile_source_scene(registries, tmp_path):
    """A statefile scene whose back-wall texture ships FALLOFF_C in the
    library: both packages compile it first (id 0, no stdlib falloff
    bound), bind the other textures to the same ids, assemble the same
    leaves and render alike (cluster route, 24x24, 4 passes)."""
    descs = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        descs[name] = proc_desc(pkg, tmp_path, source=True)
        (tmp_path / "falloff.c").write_text(FALLOFF_C)
    with pytest.warns(UserWarning, match="noise"):
        js = jscene.assemble(descs["jax"])
    with pytest.warns(UserWarning, match="noise"):
        ps = pscene.assemble(descs["port"])
    _assert_same_leaves(jax_leaves(js), pscene.scene_leaves(ps))
    assert jax_settings(js) == dataclasses.asdict(ps.settings)
    names = [[f.__name__ for f, _ in reg]
             for reg in (jproc._REGISTRY, pproc._REGISTRY)]
    assert names[0] == names[1] == ["proctex_prtex1_main", "hexaplanar",
                                    "ao_dirt"]
    assert [n for _, n in pproc._REGISTRY] == [n for _, n in jproc._REGISTRY] \
        == [7, 6, 7]
    assert ps.materials.diff_proc.tolist()[:4] == [2, 0, 1, -1]

    img_j, rays_j = jpt.render_passes(js, jnp.uint32(0), jnp.uint32(777),
                                      n_pass=4, max_depth=3)
    img_j = np.asarray(img_j) / 4
    img_p, rays_p = tpt.render_passes(to_port(js, traversal="cluster"), 0,
                                      777, n_pass=4, max_depth=3,
                                      device="cpu")
    img_p = img_p.numpy() / 4
    assert np.isfinite(img_p).all() and img_p.mean() > 0.01
    assert (np.abs(img_p - img_j).max(-1) <= 1e-3).mean() >= 0.99
    assert abs(int(rays_p) - float(rays_j)) <= 1e-3 * float(rays_j)


def test_source_cache_is_never_stale(registries):
    """The port reuses a cached source id only while the registry still
    holds that shader there: after clear_registry and a stdlib falloff at
    id 0, the cached source compiles again and binds its own shader. Two
    libraries that both ship 'falloff.c' with different sources get one
    shader each."""
    reg = pproc._REGISTRY
    assert pproc.register_stdlib_instance("falloff", "falloff.c",
                                          source=FALLOFF_C) == 0
    pproc.clear_registry()
    assert pproc.register_proc_tex(pproc.falloff) == 0
    k = pproc.register_stdlib_instance("falloff", "falloff.c",
                                       source=FALLOFF_C)
    assert k == 1 and reg[1][0].__name__ == "proctex_prtex1_main"
    assert reg[0][0] is pproc.falloff
    assert pproc.register_stdlib_instance("falloff", "falloff.c",
                                          source=FALLOFF_C) == 1
    other = FALLOFF_C.replace("color1 * (1.0f - cos_a)",
                              "color2 * (1.0f - cos_a)")
    m = pproc.register_stdlib_instance("falloff", "falloff.c", source=other)
    assert m == 2 and pproc.num_proc_tex() == 3
    uv, pos, nrm, wo, args, ao = (torch.tensor(x) for x in _inputs(R=64))
    a = reg[1][0](uv, pos, nrm, wo, args, _s2d_p, ao)
    b = reg[2][0](uv, pos, nrm, wo, args, _s2d_p, ao)
    assert torch.allclose(b[:, :3], args[:, 3:6], atol=1e-6)
    assert not torch.allclose(a[:, :3], b[:, :3], atol=1e-3)
