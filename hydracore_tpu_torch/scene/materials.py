"""Material table: the fixed-width SoA record of the JAX package's
scene/materials.py and its statefile XML compiler (build_material_table).

Every material is ONE record with up to four lobes (emission / diffuse /
reflection / transparency); pack_mat_attr flattens a table into one
(M, MA_WIDTH) float32 row per material (small ints stored as exact
floats) and bake_tex_meta joins each texture channel's meta row.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from hydracore_tpu_torch.scene.statefile import (SceneDesc, get_color,
                                                 get_float, get_tex_id,
                                                 parse_floats)
from hydracore_tpu_torch.utils.device import tree_to

# reflection distribution enum
REFL_NONE = 0
REFL_PHONG = 1
REFL_GGX = 2
REFL_BECKMANN = 3
REFL_MIRROR = 4

_GLOSS_ANCHOR_POW = np.array(
    [1.0, 1.5, 2.0, 5.0, 8.0, 12.0, 32.0, 82.0, 300.0, 2700.0, 1.0e6],
    np.float32,
)


def cos_power_from_gloss(gloss: float) -> float:
    """Glossiness -> phong cosine power.

    Log-space interpolation through the anchor values of the reference's
    piecewise-cubic table (cmaterial.h:438-465 glosscoeff col 3) — same
    endpoints per 0.1 bucket, smooth in between.
    """
    g = float(np.clip(gloss, 0.0, 1.0))
    x = g * 10.0
    k = min(int(x), 9)
    f = x - k
    lo, hi = np.log(_GLOSS_ANCHOR_POW[k]), np.log(_GLOSS_ANCHOR_POW[k + 1])
    return float(np.exp(lo + (hi - lo) * f))


def roughness_from_gloss(gloss: float) -> float:
    """Glossiness -> microfacet alpha (GGX/Beckmann), ref cmaterial.h:782."""
    return float(np.clip(1.0 - gloss, 0.0, 1.0))


@dataclass
class MaterialTable:
    """SoA material table (all arrays length M): numpy while the host
    compiler builds it, tensors once the scene is finalized."""

    em_color: np.ndarray  # (M,3)
    em_tex: np.ndarray  # (M,)
    diff_color: np.ndarray  # (M,3)
    diff_tex: np.ndarray  # (M,)
    diff_rough: np.ndarray  # (M,) oren-nayar sigma; 0 = lambert
    refl_color: np.ndarray  # (M,3)
    refl_tex: np.ndarray  # (M,)
    refl_gloss: np.ndarray  # (M,)
    refl_cospow: np.ndarray  # (M,) phong power from gloss
    refl_alpha: np.ndarray  # (M,) microfacet alpha from gloss
    refl_dist: np.ndarray  # (M,) REFL_* enum
    fresnel_ior: np.ndarray  # (M,)
    fresnel_on: np.ndarray  # (M,)
    transp_color: np.ndarray  # (M,3)
    transp_gloss: np.ndarray  # (M,)
    transp_ior: np.ndarray  # (M,)
    thin_walled: np.ndarray  # (M,) int
    fog_color: np.ndarray  # (M,3)
    fog_mult: np.ndarray  # (M,)
    opacity_tex: np.ndarray  # (M,)
    skip_shadow: np.ndarray  # (M,) int
    light_id: np.ndarray  # (M,) statefile light id or -1
    diff_proc: np.ndarray  # (M,) procedural texture id (ops/proctex.py) or -1
    bump_tex: np.ndarray  # (M,) normal-map texture slot (0 = none)
    bump_amount: np.ndarray  # (M,)
    transl_color: np.ndarray  # (M,3) diffuse-transmission (translucency)
    transl_tex: np.ndarray  # (M,)
    refl_aniso: np.ndarray  # (M,) anisotropy in [0,1)
    refl_aniso_rot: np.ndarray  # (M,) rotation of the aniso frame (turns)
    blend_node: np.ndarray  # (M,) bottom material id of a blend, or -1
    blend_type: np.ndarray  # (M,) 0 none / 1 mask / 2 fresnel / 3 falloff
    blend_tex: np.ndarray  # (M,) mask texture slot (1 = white)
    blend_ior: np.ndarray  # (M,) fresnel-blend ior
    blend_top: np.ndarray  # (M,) top material id when the top is itself a blend, else -1
    proc_args: np.ndarray  # (M,8) proc-tex arg stack (prtexDataTail analogue)
    # subsurface scattering (ref SSSMaterial, PlainMaterialConverter.cpp:716
    # + CPUExp_IntegratorSSS.cpp random-walk semantics)
    sss_density: np.ndarray  # (M,) medium density multiplier
    sss_absorption: np.ndarray  # (M,3) absorption cross-section (x density)
    sss_scattering: np.ndarray  # (M,) scattering cross-section (x density)
    sss_phase: np.ndarray  # (M,) Henyey-Greenstein g
    sss_transmission: np.ndarray  # (M,) boundary diffuse-transmission prob
    # proc-tex AO input channel (PROC_TEX_AO_*, RenderDriverRTE_ProcTex
    # .cpp:290-340): hemisphere occlusion fed to the bound proc texture
    ao_type: np.ndarray  # (M,) 0 none / 1 up / 2 down / 3 both
    ao_length: np.ndarray  # (M,) probe ray length (world units)

    def to(self, device) -> "MaterialTable":
        return tree_to(self, device)


# ----------------------------------------------------------------------------
# Packed material row: ALL per-material scalars in ONE float32 row, so
# shading fetches one row per ray. Small ints are stored as exact float32;
# consumers cast back. The layout is the JAX package's, bit for bit (keep in
# sync with bsdf/core.fetch_material):
MA_EM = 0            # [0:3)  em_color
MA_DIFF = 3          # [3:6)  diff_color
MA_REFL = 6          # [6:9)  refl_color
MA_TRANSP = 9        # [9:12) transp_color
MA_TRANSL = 12       # [12:15) transl_color
MA_DIFF_ROUGH = 15
MA_REFL_COSPOW = 16
MA_REFL_ALPHA = 17
MA_REFL_DIST = 18
MA_FRESNEL_IOR = 19
MA_FRESNEL_ON = 20
MA_TRANSP_GLOSS = 21
MA_TRANSP_IOR = 22
MA_THIN_WALLED = 23
MA_LIGHT_ID = 24
MA_BUMP_TEX = 25
MA_EM_TEX = 26
MA_DIFF_TEX = 27
MA_REFL_TEX = 28
MA_TRANSL_TEX = 29
MA_OPACITY_TEX = 30
MA_DIFF_PROC = 31
MA_BLEND_NODE = 32
MA_BLEND_TYPE = 33
MA_BLEND_TEX = 34
MA_BLEND_IOR = 35
MA_REFL_ANISO = 36
MA_REFL_ANISO_ROT = 37
MA_SKIP_SHADOW = 38
MA_BLEND_TOP = 39
MA_SSS_DENSITY = 40
MA_SSS_ABSORPTION = 41  # [41:44)
MA_SSS_SCATTERING = 44
MA_SSS_PHASE = 45
MA_SSS_TRANSMISSION = 46
MA_PROC_ARGS = 48  # [48:56) per-material proc-tex arg stack
MA_FOG_COLOR = 56  # [56:59) thick-glass Beer fog (cmaterial.h:2787)
MA_FOG_MULT = 59
MA_AO_TYPE = 60  # proc-tex AO input (PROC_TEX_AO_TYPE/LENGTH)
MA_AO_LENGTH = 61
MA_WIDTH = 62

# Baked texture-channel meta (finalize_scene bake_tex_meta): the (K, 12)
# tex_meta row of each texture channel appended to the material row.
MA_META_EM = MA_WIDTH
MA_META_DIFF = MA_WIDTH + 12
MA_META_REFL = MA_WIDTH + 24
MA_META_TRANSL = MA_WIDTH + 36
MA_META_OPACITY = MA_WIDTH + 48
MA_META_BUMP = MA_WIDTH + 60
MA_META_BLEND = MA_WIDTH + 72
MA_WIDTH_FULL = MA_WIDTH + 84

_META_CHANNELS = (
    (MA_EM_TEX, MA_META_EM), (MA_DIFF_TEX, MA_META_DIFF),
    (MA_REFL_TEX, MA_META_REFL), (MA_TRANSL_TEX, MA_META_TRANSL),
    (MA_OPACITY_TEX, MA_META_OPACITY), (MA_BUMP_TEX, MA_META_BUMP),
    (MA_BLEND_TEX, MA_META_BLEND),
)


def bake_tex_meta(mat_attr: np.ndarray, tex_meta: np.ndarray) -> np.ndarray:
    """(M, MA_WIDTH) rows -> (M, MA_WIDTH_FULL) with each texture channel's
    tex_meta row joined in (static join: the id->meta map is fixed at build
    time). Out-of-range/negative ids take row 0 (the white texel)."""
    M = mat_attr.shape[0]
    out = np.zeros((M, MA_WIDTH_FULL), np.float32)
    out[:, :MA_WIDTH] = mat_attr
    K = tex_meta.shape[0]
    for id_col, meta_col in _META_CHANNELS:
        ids = np.clip(mat_attr[:, id_col].astype(np.int64), 0, K - 1)
        out[:, meta_col:meta_col + 12] = tex_meta[ids]
    return out


def pack_mat_attr(mt: "MaterialTable") -> np.ndarray:
    """(M, MA_WIDTH) float32 packed material rows (layout above).

    AO params propagate from blend leaves up to their roots here: the AO
    probe gate reads the HIT material's row (the blend ROOT) before the
    fetch walk resolves a leaf, so a root row must carry the max of its
    tree."""
    M = np.asarray(mt.em_color).shape[0]
    ao_t = np.asarray(mt.ao_type, np.float32).copy()
    ao_l = np.asarray(mt.ao_length, np.float32).copy()
    bn = np.asarray(mt.blend_node, np.int64)
    bt = np.asarray(mt.blend_top, np.int64)
    for _ in range(8):  # bounded fixpoint over blend-tree depth
        prev_t = ao_t.copy()
        for child in (bn, bt):
            ok = (child >= 0) & (child < M)
            ci = np.where(ok, child, 0)
            ao_t = np.where(ok, np.maximum(ao_t, ao_t[ci]), ao_t)
            ao_l = np.where(ok, np.maximum(ao_l, ao_l[ci]), ao_l)
        if (ao_t == prev_t).all():
            break
    a = np.zeros((M, MA_WIDTH), np.float32)
    a[:, MA_EM:MA_EM + 3] = np.asarray(mt.em_color)
    a[:, MA_DIFF:MA_DIFF + 3] = np.asarray(mt.diff_color)
    a[:, MA_REFL:MA_REFL + 3] = np.asarray(mt.refl_color)
    a[:, MA_TRANSP:MA_TRANSP + 3] = np.asarray(mt.transp_color)
    a[:, MA_TRANSL:MA_TRANSL + 3] = np.asarray(mt.transl_color)
    a[:, MA_SSS_ABSORPTION:MA_SSS_ABSORPTION + 3] = np.asarray(mt.sss_absorption)
    a[:, MA_PROC_ARGS:MA_PROC_ARGS + 8] = np.asarray(mt.proc_args)
    a[:, MA_FOG_COLOR:MA_FOG_COLOR + 3] = np.asarray(mt.fog_color)
    a[:, MA_FOG_MULT] = np.asarray(mt.fog_mult)
    a[:, MA_AO_TYPE] = ao_t
    a[:, MA_AO_LENGTH] = ao_l
    for col, field in [
        (MA_DIFF_ROUGH, mt.diff_rough), (MA_REFL_COSPOW, mt.refl_cospow),
        (MA_REFL_ALPHA, mt.refl_alpha), (MA_REFL_DIST, mt.refl_dist),
        (MA_FRESNEL_IOR, mt.fresnel_ior), (MA_FRESNEL_ON, mt.fresnel_on),
        (MA_TRANSP_GLOSS, mt.transp_gloss), (MA_TRANSP_IOR, mt.transp_ior),
        (MA_THIN_WALLED, mt.thin_walled), (MA_LIGHT_ID, mt.light_id),
        (MA_BUMP_TEX, mt.bump_tex), (MA_EM_TEX, mt.em_tex),
        (MA_DIFF_TEX, mt.diff_tex), (MA_REFL_TEX, mt.refl_tex),
        (MA_TRANSL_TEX, mt.transl_tex), (MA_OPACITY_TEX, mt.opacity_tex),
        (MA_DIFF_PROC, mt.diff_proc), (MA_BLEND_NODE, mt.blend_node),
        (MA_BLEND_TYPE, mt.blend_type), (MA_BLEND_TEX, mt.blend_tex),
        (MA_BLEND_IOR, mt.blend_ior), (MA_REFL_ANISO, mt.refl_aniso),
        (MA_REFL_ANISO_ROT, mt.refl_aniso_rot),
        (MA_SKIP_SHADOW, mt.skip_shadow),
        (MA_BLEND_TOP, mt.blend_top),
        (MA_SSS_DENSITY, mt.sss_density),
        (MA_SSS_SCATTERING, mt.sss_scattering),
        (MA_SSS_PHASE, mt.sss_phase),
        (MA_SSS_TRANSMISSION, mt.sss_transmission),
    ]:
        a[:, col] = np.asarray(field).astype(np.float32)
    return a


_DIST_MAP = {
    "phong": REFL_PHONG,
    "blinn": REFL_PHONG,
    "torranceparrow": REFL_BECKMANN,
    "torrance_sparrow": REFL_BECKMANN,
    "beckmann": REFL_BECKMANN,
    "ggx": REFL_GGX,
    "trggx": REFL_GGX,
    "mirror": REFL_MIRROR,
}


def _parse_proc_args(tex_node, tex_remap: np.ndarray) -> np.ndarray:
    """Flatten a texref_proc binding's <arg> stack into 8 floats
    (ReadAllProcTexArgsFromMaterialNode, RenderDriverRTE_ProcTex.cpp:116-190:
    sampler2D/int args push ids, floatN push components, in child order).
    sampler2D ids are remapped to packed texture slots."""
    out: list[float] = []
    for arg in tex_node.findall("arg"):
        atype = (arg.get("type") or "float").lower()
        vals = parse_floats(arg.get("val"), []) or []
        if atype in ("sampler2d", "int", "unsigned"):
            for v in vals:
                tid = int(v)
                if atype == "sampler2d":
                    tid = int(tex_remap[tid]) if 0 <= tid < len(tex_remap) else 0
                out.append(float(tid))
        else:
            out.extend(float(v) for v in vals)
    a = np.zeros(8, np.float32)
    a[: min(len(out), 8)] = out[:8]
    return a


def _compile_one(node, rec: dict, tex_remap: np.ndarray,
                 proc_map: dict | None = None):
    def tex(parent):
        tid = get_tex_id(parent)
        if tid < 0 or tid >= len(tex_remap):
            return 0
        return int(tex_remap[tid])

    def bind_proc(parent):
        """texref_proc on a color slot -> (registered proc id, arg stack)."""
        if proc_map is None or parent is None:
            return
        t = parent.find("texture")
        if t is None:
            return
        tid = int(t.get("id", -1))
        if t.get("type") != "texref_proc" and tid not in proc_map:
            return
        pid, ao_t, ao_len = proc_map.get(tid, (-1, 0, 0.0))
        if pid < 0:
            return
        rec["diff_proc"] = pid
        rec["proc_args"] = _parse_proc_args(t, tex_remap)
        # AO input channel declared on the proc texture (<ao hemisphere=…
        # length=…>, ReadAOFromNode) lands in the binding material's row
        rec["ao_type"] = ao_t
        rec["ao_length"] = ao_len

    em = node.find("emission")
    if em is not None:
        mult = get_float(em, "multiplier", 1.0)
        rec["em_color"] = get_color(em, "color") * mult
        rec["em_tex"] = tex(em)

    dif = node.find("diffuse")
    if dif is not None:
        rec["diff_color"] = get_color(dif, "color")
        rec["diff_tex"] = tex(dif)
        bind_proc(dif)
        brdf = (dif.get("brdf_type") or "lambert").lower()
        if brdf == "orennayar":
            rec["diff_rough"] = get_float(dif, "roughness", 0.5)

    refl = node.find("reflectivity")
    if refl is not None:
        rec["refl_color"] = get_color(refl, "color")
        rec["refl_tex"] = tex(refl)
        an = refl.find("anisotropy")
        if an is not None:
            rec["refl_aniso"] = float(an.get("val", 0.0))
            rec["refl_aniso_rot"] = float(an.get("rot", 0.0))
        gloss = get_float(refl, "glossiness", 1.0)
        rec["refl_gloss"] = gloss
        rec["refl_cospow"] = cos_power_from_gloss(gloss)
        rec["refl_alpha"] = max(roughness_from_gloss(gloss), 1e-3)
        brdf = (refl.get("brdf_type") or "phong").lower()
        dist = _DIST_MAP.get(brdf, REFL_PHONG)
        if gloss >= 0.999 and dist != REFL_MIRROR:
            dist = REFL_MIRROR  # delta limit (ref: Mirror class split)
        rec["refl_dist"] = dist
        fr = refl.find("fresnel")
        rec["fresnel_on"] = get_float(refl, "fresnel", 0.0) if fr is not None else 0.0
        rec["fresnel_ior"] = get_float(refl, "fresnel_ior", get_float(refl, "fresnel_IOR", 1.5))

    tr = node.find("transparency")
    if tr is not None:
        rec["transp_color"] = get_color(tr, "color")
        rec["transp_gloss"] = get_float(tr, "glossiness", 1.0)
        rec["transp_ior"] = get_float(tr, "ior", get_float(tr, "IOR", 1.5))
        rec["thin_walled"] = int(get_float(tr, "thin_walled", 0.0))
        rec["fog_color"] = get_color(tr, "fog_color", (1, 1, 1))
        rec["fog_mult"] = get_float(tr, "fog_multiplier", 0.0)

    op = node.find("opacity")
    if op is not None:
        rec["opacity_tex"] = tex(op)
        rec["skip_shadow"] = int(get_float(op, "skip_shadow", 0.0))

    tl = node.find("translucency")
    if tl is not None:
        mult = get_float(tl, "multiplier", 1.0)
        rec["transl_color"] = get_color(tl, "color") * mult
        rec["transl_tex"] = tex(tl)

    # displacement -> normal map (converted at scene build; the reference
    # bakes aux normal maps in RenderDriverRTE_AuxTextures.cpp)
    displ = node.find("displacement")
    if displ is not None and displ.get("type") == "height_bump":
        hm = displ.find("height_map")
        if hm is not None:
            t = hm.find("texture")
            if t is not None:
                rec["bump_src_tex"] = int(t.get("id", -1))
                rec["bump_amount"] = float(hm.get("amount", 1.0))

    # subsurface scattering block. The reference's SSSMaterial
    # (PlainMaterialConverter.cpp:716) is only reachable from its
    # experimental CPU integrators (CPUExp_IntegratorSSS.cpp) — no XML path
    # constructs it — so we expose the same parameter set under an <sss>
    # node (absorption / scattering / density / phase / transmission).
    sss = node.find("sss")
    if sss is not None:
        rec["sss_density"] = get_float(sss, "density", 1.0)
        rec["sss_absorption"] = get_color(sss, "absorption", (0, 0, 0))
        rec["sss_scattering"] = get_float(sss, "scattering", 1.0)
        rec["sss_phase"] = get_float(sss, "phase", 0.0)
        rec["sss_transmission"] = get_float(sss, "transmission", 0.6)

    if node.get("light_id") is not None:
        rec["light_id"] = int(node.get("light_id"))


def _blank_record() -> dict:
    return dict(
        em_color=np.zeros(3, np.float32),
        em_tex=0,
        diff_color=np.zeros(3, np.float32),
        diff_tex=0,
        diff_rough=0.0,
        refl_color=np.zeros(3, np.float32),
        refl_tex=0,
        refl_gloss=1.0,
        refl_cospow=1e6,
        refl_alpha=1e-3,
        refl_dist=REFL_NONE,
        fresnel_ior=1.5,
        fresnel_on=0.0,
        transp_color=np.zeros(3, np.float32),
        transp_gloss=1.0,
        transp_ior=1.5,
        thin_walled=0,
        fog_color=np.ones(3, np.float32),
        fog_mult=0.0,
        opacity_tex=0,
        skip_shadow=0,
        light_id=-1,
        diff_proc=-1,
        bump_tex=0,
        bump_amount=0.0,
        transl_color=np.zeros(3, np.float32),
        transl_tex=0,
        refl_aniso=0.0,
        refl_aniso_rot=0.0,
        blend_node=-1,
        blend_type=0,
        blend_tex=0,
        blend_ior=1.5,
        blend_top=-1,
        proc_args=np.zeros(8, np.float32),
        sss_density=0.0,
        sss_absorption=np.zeros(3, np.float32),
        sss_scattering=0.0,
        sss_phase=0.0,
        sss_transmission=0.0,
        ao_type=0,
        ao_length=0.0,
    )


def build_material_table(desc: SceneDesc, tex_remap: np.ndarray,
                         bump_slots: dict | None = None) -> MaterialTable:
    """bump_slots: {material_id: normal-map texture slot} from the aux
    normal-map bake (scene/textures.py)."""
    max_id = max(desc.materials.keys(), default=-1)
    n = max_id + 1

    # statefile proc textures: register a stdlib instance for every
    # declared `type="proc"` texture that a material actually binds
    # (texref_proc). Unreferenced declarations cost nothing (the bundled
    # teapot_cylinder/test_aniso* scenes declare falloff/hexaplanar without
    # binding them, matching the reference's lazy table fill). A texture
    # whose .c source lies in the library is compiled from it
    # (ops/proctex_c), falling back to the stdlib match only when the source
    # is outside the translator's subset.
    from hydracore_tpu_torch.ops.proctex import register_stdlib_instance

    proc_map: dict[int, tuple] = {}  # tid -> (proc id, ao_type, ao_length)
    referenced = set()
    for node in desc.materials.values():
        for t in node.iter("texture"):
            if t.get("type") == "texref_proc":
                referenced.add(int(t.get("id", -1)))
    for tid, td in desc.textures.items():
        if td.proc_name and tid in referenced:
            source = None
            loc = td.loc or ""
            if loc and desc.lib_dir:
                path = os.path.join(desc.lib_dir, loc)
                if os.path.exists(path) and path.endswith(".c"):
                    try:
                        with open(path, "r", errors="replace") as f:
                            source = f.read()
                    except OSError:
                        source = None
            proc_map[tid] = (register_stdlib_instance(
                                 td.proc_name, loc, main=td.proc_main,
                                 source=source, gen_args=td.gen_args),
                             td.ao_type, td.ao_length)

    recs = []
    for mid in range(max(n, 1)):
        rec = _blank_record()
        node = desc.materials.get(mid)
        if node is not None:
            mtype = node.get("type", "hydra_material")
            if mtype in ("hydra_material", "shadow_catcher"):
                _compile_one(node, rec, tex_remap, proc_map)
            elif mtype == "hydra_blend":
                # blend node (PlainMaterialConverter.cpp:750 BlendMask):
                # THIS record compiles the top leaf; blend_node points to
                # the bottom leaf's own record; the per-ray weight comes
                # from the blend type (mask texture / fresnel / falloff)
                # at fetch time (bsdf/core.fetch_material)
                top = node.get("node_top")
                bot = node.get("node_bottom")
                if top is not None and int(top) in desc.materials:
                    top_node = desc.materials[int(top)]
                    if top_node.get("type") == "hydra_blend":
                        # nested blend on the TOP branch: defer to that
                        # record (resolved by the fetch-time random walk,
                        # cmaterial.h:2345 materialRandomWalkBRDF)
                        rec["blend_top"] = int(top)
                    else:
                        _compile_one(top_node, rec, tex_remap, proc_map)
                if bot is not None:
                    rec["blend_node"] = int(bot)
                bl = node.find("blend")
                btype = (bl.get("type") if bl is not None else "") or ""
                rec["blend_type"] = {"mask_blend": 1, "fresnel_blend": 2,
                                     "faloff_blend": 3,
                                     "falloff_blend": 3}.get(btype, 1)
                if bl is not None:
                    rec["blend_ior"] = get_float(bl, "fresnel_ior", 1.5)
                    mask = bl.find("mask")
                    if mask is not None:
                        t = mask.find("texture")
                        if t is not None:
                            tid = int(t.get("id", -1))
                            if 0 <= tid < len(tex_remap):
                                rec["blend_tex"] = int(tex_remap[tid])
        if bump_slots and mid in bump_slots:
            rec["bump_tex"] = bump_slots[mid]
        recs.append(rec)

    def stack(key, dtype):
        return np.asarray([r[key] for r in recs], dtype)

    return MaterialTable(
        em_color=stack("em_color", np.float32),
        em_tex=stack("em_tex", np.int32),
        diff_color=stack("diff_color", np.float32),
        diff_tex=stack("diff_tex", np.int32),
        diff_rough=stack("diff_rough", np.float32),
        refl_color=stack("refl_color", np.float32),
        refl_tex=stack("refl_tex", np.int32),
        refl_gloss=stack("refl_gloss", np.float32),
        refl_cospow=stack("refl_cospow", np.float32),
        refl_alpha=stack("refl_alpha", np.float32),
        refl_dist=stack("refl_dist", np.int32),
        fresnel_ior=stack("fresnel_ior", np.float32),
        fresnel_on=stack("fresnel_on", np.float32),
        transp_color=stack("transp_color", np.float32),
        transp_gloss=stack("transp_gloss", np.float32),
        transp_ior=stack("transp_ior", np.float32),
        thin_walled=stack("thin_walled", np.int32),
        fog_color=stack("fog_color", np.float32),
        fog_mult=stack("fog_mult", np.float32),
        opacity_tex=stack("opacity_tex", np.int32),
        skip_shadow=stack("skip_shadow", np.int32),
        light_id=stack("light_id", np.int32),
        diff_proc=stack("diff_proc", np.int32),
        bump_tex=stack("bump_tex", np.int32),
        bump_amount=stack("bump_amount", np.float32),
        transl_color=stack("transl_color", np.float32),
        transl_tex=stack("transl_tex", np.int32),
        refl_aniso=stack("refl_aniso", np.float32),
        refl_aniso_rot=stack("refl_aniso_rot", np.float32),
        blend_node=stack("blend_node", np.int32),
        blend_type=stack("blend_type", np.int32),
        blend_tex=stack("blend_tex", np.int32),
        blend_ior=stack("blend_ior", np.float32),
        blend_top=stack("blend_top", np.int32),
        proc_args=stack("proc_args", np.float32),
        sss_density=stack("sss_density", np.float32),
        sss_absorption=stack("sss_absorption", np.float32),
        sss_scattering=stack("sss_scattering", np.float32),
        sss_phase=stack("sss_phase", np.float32),
        sss_transmission=stack("sss_transmission", np.float32),
        ao_type=stack("ao_type", np.int32),
        ao_length=stack("ao_length", np.float32),
    )
