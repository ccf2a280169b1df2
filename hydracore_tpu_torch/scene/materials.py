"""Material table: the fixed-width SoA record of the JAX package's
scene/materials.py, without the statefile XML compiler (a later slice).

Every material is ONE record with up to four lobes (emission / diffuse /
reflection / transparency); pack_mat_attr flattens a table into one
(M, MA_WIDTH) float32 row per material (small ints stored as exact
floats) and bake_tex_meta joins each texture channel's meta row.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hydracore_tpu_torch.utils.device import tree_to

# reflection distribution enum
REFL_NONE = 0
REFL_PHONG = 1
REFL_GGX = 2
REFL_BECKMANN = 3
REFL_MIRROR = 4


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
