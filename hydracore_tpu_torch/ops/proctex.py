"""Procedural textures (torch): a registry of callables and the statefile
stdlib.

The JAX package's ops/proctex.py. The reference splices user OpenCL
snippets into its texture kernel and recompiles at run time
(RenderDriverRTE_ProcTex.cpp); here a procedural texture is a Python
callable over ray batches, registered once, whose id a material record
carries (MaterialTable.diff_proc). Statefile `type="proc"` textures bind by
their `name` or their `prtexN_<name>` main symbol to the stdlib below
(scene/materials.py:build_material_table); their per-material `<arg>`
stacks ride the material row (MA_PROC_ARGS).

A texture that ships its C source is compiled by ops/proctex_c (the C
subset the reference's shaders use, evaluated over the ray batch) and
registered with the 7-argument protocol; a source outside that subset
warns and falls back to the stdlib match, as in the JAX package.

Callable protocol, chosen by the count of required parameters:

    fn(uv (R,2), pos (R,3), normal (R,3))                            3
    fn(uv, pos, normal, wo (R,3), args (R,A), sample2d)              6
    fn(uv, pos, normal, wo, args, sample2d, ao (R,))                 7

-> color (R,3), where sample2d(slot (R,) float-coded texture id, uv (R,2))
-> (R,4) samples the scene's texture heap (ops/texture.py:tex_fetch).

The registry is per process and separate from the JAX package's: to
compare the two on one scene, register the same functions in the same
order in both.
"""
from __future__ import annotations

import inspect
import warnings

import torch

from hydracore_tpu_torch.ops.proctex_c import (ProcTexCompileError,
                                               compile_proc_tex)

_REGISTRY: list = []  # entries: (fn, n_params)


def register_proc_tex(fn) -> int:
    """Register a procedural texture; returns its id for material records
    (MaterialTable.diff_proc)."""
    try:
        n = sum(1 for p in inspect.signature(fn).parameters.values()
                if p.default is inspect.Parameter.empty)
    except (TypeError, ValueError):
        n = 3
    _REGISTRY.append((fn, n))
    return len(_REGISTRY) - 1


def clear_registry():
    _REGISTRY.clear()


def num_proc_tex() -> int:
    return len(_REGISTRY)


def eval_proc_tex(proc_id, uv, pos, normal, wo=None, args=None, scene=None,
                  ao=None):
    """Evaluate the registered textures for per-ray ids (R,); id < 0 ->
    white. Every registered function runs on the whole batch and the id
    selects (a scene has few; the reference switches once per hit,
    texproc.cl:94). ao (R,): the hemisphere occlusion input (readAttr_AO,
    texproc.cl:56), 1 everywhere when the scene traces no AO probes."""
    out = torch.ones(uv.shape[:-1] + (3,), dtype=torch.float32,
                     device=uv.device)
    if not _REGISTRY:
        return out
    R = uv.shape[0]
    if wo is None:
        wo = normal
    if args is None:
        args = torch.zeros((R, 8), dtype=torch.float32, device=uv.device)
    if ao is None:
        ao = torch.ones(uv.shape[:-1], dtype=torch.float32, device=uv.device)

    if scene is not None:
        from hydracore_tpu_torch.ops.texture import tex_fetch

        def sample2d(slot_f, st):
            return tex_fetch(scene, slot_f.to(torch.int32), st)
    else:
        def sample2d(slot_f, st):
            return torch.ones(st.shape[:-1] + (4,), dtype=torch.float32,
                              device=st.device)

    for i, (fn, n) in enumerate(_REGISTRY):
        if n <= 3:
            val = fn(uv, pos, normal)
        elif n <= 6:
            val = fn(uv, pos, normal, wo, args, sample2d)
        else:  # AO-consuming shader (readAttr_AO semantics)
            val = fn(uv, pos, normal, wo, args, sample2d, ao)
        out = torch.where((proc_id == i)[..., None], val[..., :3], out)
    return out


# ----------------------------------------------------------------------------
# Stdlib: the procedural textures the reference ships under
# pluginFiles/ProceduralTextures, each the counterpart of one prtexN_main.
# ----------------------------------------------------------------------------

def falloff(uv, pos, normal, wo, args, sample2d):
    """mix(color1, color2, |cos(N, V)|) (falloff.c prtex1_main).
    args: [0:3) color1, [3:6) color2."""
    cos_a = (normal * wo).sum(dim=-1, keepdim=True).abs()
    c1, c2 = args[:, 0:3], args[:, 3:6]
    return c1 * (1.0 - cos_a) + c2 * cos_a


def hexaplanar(uv, pos, normal, wo, args, sample2d):
    """Triplanar world-space projection with a texture per sign of each
    axis (hexaplanar.c prtex2_main). args: [texX1 texY1 texZ1 texX2 texY2
    texZ2 blendSize mapScale] (sampler slots float-coded)."""
    blend = torch.clamp(args[:, 6], min=1e-3)
    scale = torch.clamp(args[:, 7], min=1e-6)
    tx = torch.where(normal[:, 0] < 0, args[:, 0], args[:, 3])
    ty = torch.where(normal[:, 1] < 0, args[:, 1], args[:, 4])
    tz = torch.where(normal[:, 2] < 0, args[:, 2], args[:, 5])

    w = normal.abs()
    w = torch.pow(torch.clamp(w, min=1e-6), blend[:, None])
    w = torch.clamp(w, min=1e-5) / (w * w).sum(dim=-1, keepdim=True)
    w = w / w.sum(dim=-1, keepdim=True)

    s = scale[:, None]
    y_uv = torch.stack([pos[:, 0], pos[:, 2]], -1) / s
    x_uv = torch.stack([pos[:, 2], pos[:, 1]], -1) / s
    z_uv = torch.stack([pos[:, 0], pos[:, 1]], -1) / s
    cx = sample2d(tx, x_uv)[:, :3]
    cy = sample2d(ty, y_uv)[:, :3]
    cz = sample2d(tz, z_uv)[:, :3]
    return cx * w[:, 0:1] + cy * w[:, 1:2] + cz * w[:, 2:3]


def ao_dirt(uv, pos, normal, wo, args, sample2d, ao):
    """mix(dirt color, clean color, ao): dirt in the crevices (a readAttr_AO
    consumer, texproc.cl:56). args: [0:3) dirt color, [3:6) clean color."""
    c_dirt, c_clean = args[:, 0:3], args[:, 3:6]
    a = torch.clamp(ao, 0.0, 1.0)[:, None]
    return c_dirt * (1.0 - a) + c_clean * a


#: statefile `type="proc"` textures resolve here by texture `name` or by
#: the .c main symbol (prtexN_<name>)
STDLIB = {
    "falloff": falloff,
    "hexaplanar": hexaplanar,
    "ao_dirt": ao_dirt,
    "dirt": ao_dirt,
}


_STDLIB_IDS: dict = {}  # fn -> registered id (repeated loads must not
# grow the registry: every registered function runs on every batch)
_SOURCE_IDS: dict = {}  # (loc, main, source) -> (registered id, shader)


def register_source_instance(source: str, main: str | None = None,
                             gen_args: list | None = None,
                             cache_key: str | None = None) -> int:
    """Compile a procedural texture's C source (the statefile's .c payload)
    with ops/proctex_c and register it with arity 7 (the translated shader
    takes the ao input too), once per (`cache_key` (the library location),
    main, source): the analogue of the reference's run-time OpenCL splice
    and recompile (RenderDriverRTE_ProcTex.cpp:467-563). A cached id is
    reused only while the registry still holds its shader there. Raises
    ProcTexCompileError outside the supported subset."""
    key = (cache_key, main, source)
    if key in _SOURCE_IDS:
        i, fn = _SOURCE_IDS[key]
        if i < len(_REGISTRY) and _REGISTRY[i][0] is fn:
            return i
    fn = compile_proc_tex(source, main=main, gen_args=gen_args)
    _REGISTRY.append((fn, 7))
    _SOURCE_IDS[key] = (len(_REGISTRY) - 1, fn)
    return len(_REGISTRY) - 1


def register_stdlib_instance(name: str, loc: str = "",
                             main: str | None = None,
                             source: str | None = None,
                             gen_args: list | None = None) -> int:
    """Bind a declared statefile procedural texture: 1) its SOURCE when it
    has one (register_source_instance); a source outside the translator's
    subset warns and goes on to 2) the stdlib entry of its texture name or
    main symbol; else 3) -1 with a warning (the material renders without
    it, but never silently). Any error but ProcTexCompileError
    propagates."""
    if source:
        try:
            return register_source_instance(source, main=main,
                                            gen_args=gen_args,
                                            cache_key=loc or None)
        except ProcTexCompileError as e:
            warnings.warn(
                f"procedural texture '{name}' ({loc}): source translation "
                f"failed ({e}); falling back to the stdlib match",
                stacklevel=2)
    fn = STDLIB.get(name.lower().strip())
    if fn is None and main:
        key = main.lower().strip()
        key = key.split("_", 1)[1] if "_" in key else key  # prtexN_<name>
        fn = STDLIB.get(key)
    if fn is None:
        warnings.warn(
            f"procedural texture '{name}' ({loc}) has no stdlib "
            "implementation — register one via "
            "hydracore_tpu_torch.ops.proctex.register_proc_tex/STDLIB; "
            "the material renders without it",
            stacklevel=2,
        )
        return -1
    if fn not in _STDLIB_IDS or _STDLIB_IDS[fn] >= len(_REGISTRY) \
            or _REGISTRY[_STDLIB_IDS[fn]][0] is not fn:
        _STDLIB_IDS[fn] = register_proc_tex(fn)
    return _STDLIB_IDS[fn]


# ---- examples (the reference ships perlin-style noise in VolumePerlin)

def checker(uv, pos, normal, scale: float = 8.0):
    c = (torch.floor(uv[..., 0] * scale) + torch.floor(uv[..., 1] * scale)) % 2.0
    return torch.stack([c, c, c], -1)


_HASH_ROWS = ((127.1, 269.5, 419.2), (311.7, 183.3, 371.9),
              (74.7, 246.1, 124.6))


def _hash3(p):
    """frac(sin(p @ M^T) * 43758.5453), each three-term dot product formed
    in index order. A one-ulp change of the dot product moves the fraction
    by about 1e-2, so results agree with the JAX package's on most points,
    not all."""
    x = torch.stack([(p[..., 0] * m0 + p[..., 1] * m1) + p[..., 2] * m2
                     for m0, m1, m2 in _HASH_ROWS], -1)
    x = torch.sin(x) * 43758.5453
    return x - torch.floor(x)


def value_noise3(pos, scale: float = 2.0):
    """Trilinear value noise over world position (R,3) -> (R,)."""
    p = pos * scale
    i = torch.floor(p)
    f = p - i
    f = f * f * (3.0 - 2.0 * f)
    acc = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                corner = i + torch.tensor([dx, dy, dz], dtype=torch.float32,
                                          device=pos.device)
                v = _hash3(corner)[..., 0]
                w = ((f[..., 0] if dx else 1 - f[..., 0])
                     * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                acc = acc + v * w
    return acc


def perlin_marble(uv, pos, normal):
    n = value_noise3(pos, 2.0) + 0.5 * value_noise3(pos, 4.0) \
        + 0.25 * value_noise3(pos, 8.0)
    t = 0.5 + 0.5 * torch.sin(pos[..., 0] * 4.0 + n * 6.0)
    return torch.stack([t, t, t], -1)
