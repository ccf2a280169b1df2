"""BSDF sample/eval library — vectorized over ray batches (torch).

The JAX package's bsdf/core.py: every material is a fixed 4-lobe record
(emission / diffuse / reflection / transparency, plus translucency) and
shading is ONE-SAMPLE MIS over lobes — evaluation sums all non-delta lobes
branch-free, sampling picks a lobe proportionally to its luminance and
divides by the mixture pdf.

A material is one packed row per ray (scene.mat_attr) with the meta rows
of its textures baked in: the fetch reads the texture channels the
scene's static gates allow (ops/texture.py), lerps or walks blend trees,
and bends the shading normal by a normal map (apply_bump). Procedural
textures, SSS and fog raise at scene build (scene.check_supported).

Conventions:
  wo — unit vector from surface TOWARD the viewer (= -ray_dir)
  wi — unit vector from surface toward light / next vertex
  n  — geometric-consistent shading normal as stored (NOT pre-flipped)
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from hydracore_tpu_torch.bsdf import energy_tables as ET
from hydracore_tpu_torch.scene import materials as MC
from hydracore_tpu_torch.scene.materials import (REFL_BECKMANN, REFL_GGX,
                                                 REFL_MIRROR, REFL_NONE,
                                                 REFL_PHONG)
from hydracore_tpu_torch.utils.math3d import (dot3, make_orthonormal_basis,
                                              normalize3, reflect3, sqrt)

INV_PI = float(1.0 / math.pi)
PI = math.pi
EPS_PDF = 1e-20


class MatParams(NamedTuple):
    """Per-ray material parameters after texture fetch."""

    em_color: torch.Tensor  # (R,3)
    diff_color: torch.Tensor  # (R,3)
    diff_rough: torch.Tensor  # (R,)
    refl_color: torch.Tensor  # (R,3)
    refl_cospow: torch.Tensor  # (R,)
    refl_alpha: torch.Tensor  # (R,)
    refl_dist: torch.Tensor  # (R,) int
    fresnel_ior: torch.Tensor  # (R,)
    fresnel_on: torch.Tensor  # (R,)
    transp_color: torch.Tensor  # (R,3)
    transp_ior: torch.Tensor  # (R,)
    thin_walled: torch.Tensor  # (R,) int
    opacity: torch.Tensor  # (R,) alpha in [0,1]
    light_id: torch.Tensor  # (R,) int
    bump_tex: torch.Tensor  # (R,) normal-map slot (0 = none)
    transl_color: torch.Tensor  # (R,3) diffuse transmission
    transp_alpha: torch.Tensor  # (R,) rough-glass microfacet alpha (0=delta)
    refl_aniso: torch.Tensor  # (R,)
    refl_aniso_rot: torch.Tensor  # (R,)
    skip_shadow: torch.Tensor  # (R,) shadow-catcher opacity flag
    # the baked normal-map meta row (materials.MA_META_BUMP), bitcast ints
    # inside, and the map's rgb fetched with the other channels: a blend
    # switches both, never lerps them
    bump_meta: torch.Tensor = None  # (R, 12)
    bump_rgb: torch.Tensor = None  # (R, 3)


def luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


FEATS_ALL = ("glass", "transl", "aniso", "mscomp")


def scene_feats(scene) -> tuple:
    """Static material-feature set for this scene: lobe code that no
    material needs is skipped (semantics unchanged, the flags derive from
    the material table)."""
    st = scene.settings
    if st is None:
        return FEATS_ALL
    out = []
    if getattr(st, "has_rough_glass", True):
        out.append("glass")
    if getattr(st, "has_transl", True):
        out.append("transl")
    if getattr(st, "has_aniso", True):
        out.append("aniso")
    if getattr(st, "has_ms_comp", True):
        out.append("mscomp")
    return tuple(out)


def _gate(st, name: str) -> bool:
    """Static feature gate; permissive when settings are absent."""
    return True if st is None else bool(getattr(st, name, True))


def _mat_rows(scene, mat_id):
    n = scene.mat_attr.shape[0]
    return scene.mat_attr[torch.clamp(mat_id.long(), 0, n - 1)]


def _fetch_leaf(scene, mat_id, uv) -> MatParams:
    """One packed material row per ray (scene.mat_attr) and the texture
    channels the scene's static gates allow (emission, diffuse,
    reflection, opacity, translucency, normal map), each fetched through
    the meta row baked into the material row, all in one stacked fetch."""
    from hydracore_tpu_torch.ops.texture import tex_fetch_rows_batch

    st = scene.settings
    m = _mat_rows(scene, mat_id)

    def col(c):
        return m[:, c]

    def col3(c):
        return m[:, c:c + 3]

    def coli(c):
        return m[:, c].to(torch.int32)

    chans = []
    if _gate(st, "has_em_tex"):
        chans.append(("em", MC.MA_META_EM))
    if _gate(st, "has_diff_tex"):
        chans.append(("diff", MC.MA_META_DIFF))
    if _gate(st, "has_refl_tex"):
        chans.append(("refl", MC.MA_META_REFL))
    if _gate(st, "has_alpha"):
        chans.append(("op", MC.MA_META_OPACITY))
    if _gate(st, "has_transl") and _gate(st, "has_transl_tex"):
        chans.append(("transl", MC.MA_META_TRANSL))
    if _gate(st, "has_bump"):
        chans.append(("bump", MC.MA_META_BUMP))
    fetched = {}
    if chans:
        outs = tex_fetch_rows_batch(scene, [m[:, c:c + 12] for _, c in chans],
                                    uv)
        fetched = {nm: o for (nm, _), o in zip(chans, outs)}

    def textured(c, name):
        # an untextured channel launches nothing
        return col3(c) * fetched[name][:, :3] if name in fetched else col3(c)

    tg = col(MC.MA_TRANSP_GLOSS)
    return MatParams(
        em_color=textured(MC.MA_EM, "em"),
        diff_color=textured(MC.MA_DIFF, "diff"),
        diff_rough=col(MC.MA_DIFF_ROUGH),
        refl_color=textured(MC.MA_REFL, "refl"),
        refl_cospow=col(MC.MA_REFL_COSPOW),
        refl_alpha=col(MC.MA_REFL_ALPHA),
        refl_dist=coli(MC.MA_REFL_DIST),
        fresnel_ior=col(MC.MA_FRESNEL_IOR),
        fresnel_on=col(MC.MA_FRESNEL_ON),
        transp_color=col3(MC.MA_TRANSP),
        transp_ior=col(MC.MA_TRANSP_IOR),
        thin_walled=coli(MC.MA_THIN_WALLED),
        opacity=(fetched["op"][:, 0] if "op" in fetched
                 else torch.ones_like(tg)),
        light_id=coli(MC.MA_LIGHT_ID),
        bump_tex=coli(MC.MA_BUMP_TEX),
        transl_color=textured(MC.MA_TRANSL, "transl"),
        transp_alpha=torch.where(tg < 0.999, torch.clamp(1.0 - tg, min=1e-3),
                                 0.0),
        refl_aniso=col(MC.MA_REFL_ANISO),
        refl_aniso_rot=col(MC.MA_REFL_ANISO_ROT),
        skip_shadow=coli(MC.MA_SKIP_SHADOW),
        bump_meta=(m[:, MC.MA_META_BUMP:MC.MA_META_BUMP + 12]
                   if _gate(st, "has_bump") else None),
        bump_rgb=fetched["bump"][:, :3] if "bump" in fetched else None,
    )


def _blend_weight(scene, mrow, uv, normal, wo, pos):
    """Per-ray top weight of a blend record: mask-texture luminance, the
    Fresnel of the view angle, or falloff (BlendMaskMaterial semantics,
    PlainMaterialConverter.cpp:750)."""
    from hydracore_tpu_torch.ops.texture import tex_fetch_row

    btype = mrow[:, MC.MA_BLEND_TYPE].to(torch.int32)
    mask = tex_fetch_row(scene,
                         mrow[:, MC.MA_META_BLEND:MC.MA_META_BLEND + 12],
                         uv)[:, :3]
    w_mask = luminance(mask)
    if normal is not None and wo is not None:
        cos_v = dot3(normal, wo).abs()
    elif normal is not None and pos is not None:
        cos_v = dot3(normal, normalize3(pos)).abs()
    else:
        cos_v = torch.full_like(w_mask, 0.5)
    w_fres = fresnel_dielectric(
        cos_v, torch.clamp(mrow[:, MC.MA_BLEND_IOR], min=1.0 + 1e-4))
    w_fall = 1.0 - cos_v
    w = torch.where(btype == 2, w_fres, torch.where(btype == 3, w_fall, w_mask))
    return torch.clamp(w, 0.0, 1.0)


def resolve_blend_leaf(scene, mat_id, uv, normal, wo, pos, u_blend):
    """Stochastic blend-tree descent (materialRandomWalkBRDF,
    cmaterial.h:2345): at each blend record take the top branch with the
    probability of its blend weight, re-normalizing the uniform, else the
    bottom, until a leaf record; at most the scene's static blend_depth
    levels. Sampling branch k with probability w_k and evaluating leaf k
    alone estimates the mixture without bias."""
    st = scene.settings
    levels = 1 if st is None else max(int(getattr(st, "blend_depth", 1)), 1)
    mid = mat_id
    u = u_blend
    done = torch.zeros(mat_id.shape, dtype=torch.bool, device=mat_id.device)
    for _ in range(levels):
        mrow = _mat_rows(scene, mid)
        bn = mrow[:, MC.MA_BLEND_NODE].to(torch.int32)
        bt = mrow[:, MC.MA_BLEND_TOP].to(torch.int32)
        is_blend = (bn >= 0) | (bt >= 0)
        w = _blend_weight(scene, mrow, uv, normal, wo, pos)
        take_top = u < w
        # re-normalize the uniform for the next level (stream reuse)
        u = torch.clamp(torch.where(take_top, u / torch.clamp(w, min=1e-6),
                                    (u - w) / torch.clamp(1.0 - w, min=1e-6)),
                        0.0, 1.0 - 1e-7)
        nxt = torch.where(take_top, torch.where(bt >= 0, bt, mid), bn)
        resolved = ~is_blend | (take_top & (bt < 0))
        mid = torch.where(done | resolved, mid,
                          torch.where(take_top & (bt < 0), mid, nxt))
        done = done | resolved
    return mid


def fetch_material(scene, mat_id, uv, pos=None, normal=None, wo=None,
                   u_blend=None) -> MatParams:
    """Material record per ray, modulated by its textures (ref:
    materialLeafEval's fetch path, cmaterial.h / cfetch.h).

    Blend materials (PlainMaterialConverter.cpp:750 BlendMask): the record
    holds the top leaf and blend_node points at the bottom leaf; the
    per-ray top weight comes from the blend type (_blend_weight). One-level
    trees lerp the two leaves field by field (ints, the baked *_meta rows
    and bump_rgb switch at w = 0.5); deeper trees (settings.blend_depth >
    1) walk to one leaf a ray on u_blend (resolve_blend_leaf)."""
    st = scene.settings
    if st is not None and not st.has_blend:
        return _fetch_leaf(scene, mat_id, uv)
    if st is not None and getattr(st, "blend_depth", 1) > 1:
        if u_blend is None:
            u_blend = torch.full(mat_id.shape, 0.5, dtype=torch.float32,
                                 device=mat_id.device)
        leaf = resolve_blend_leaf(scene, mat_id, uv, normal, wo, pos, u_blend)
        return _fetch_leaf(scene, leaf, uv)
    p_top = _fetch_leaf(scene, mat_id, uv)
    mrow = _mat_rows(scene, mat_id)
    bn = mrow[:, MC.MA_BLEND_NODE].to(torch.int32)
    has = bn >= 0
    bot_id = torch.where(has, torch.clamp(bn, 0, scene.mat_attr.shape[0] - 1),
                         mat_id.to(torch.int32))
    p_bot = _fetch_leaf(scene, bot_id, uv)
    w = torch.where(has, _blend_weight(scene, mrow, uv, normal, wo, pos), 1.0)
    top = w >= 0.5

    def lerp(name, a, b):
        if a is None or b is None:
            return a if b is None else b
        if name.endswith("_meta") or name == "bump_rgb":
            return torch.where(top[:, None], a, b)
        if a.dim() == 2:
            return a * w[:, None] + b * (1.0 - w[:, None])
        if a.dtype == torch.int32:
            return torch.where(top, a, b)
        return a * w + b * (1.0 - w)

    return MatParams(*[lerp(f, a, b)
                       for f, a, b in zip(MatParams._fields, p_top, p_bot)])


def apply_bump(scene, p: MatParams, n, tang, uv):
    """Perturb the shading normal by the material's normal map in the TBN
    frame of the interpolated tangent (the shading side of the reference's
    bump pipeline). The map's rgb comes prefetched with the other channels
    (p.bump_rgb); static no-op for scenes without normal maps."""
    if not _gate(scene.settings, "has_bump"):
        return n
    has = p.bump_tex > 0
    nm = p.bump_rgb * 2.0 - 1.0
    t = normalize3(tang - dot3(tang, n)[:, None] * n)
    b = torch.stack([n[:, 1] * t[:, 2] - n[:, 2] * t[:, 1],
                     n[:, 2] * t[:, 0] - n[:, 0] * t[:, 2],
                     n[:, 0] * t[:, 1] - n[:, 1] * t[:, 0]], dim=-1)
    n2 = normalize3(nm[:, 0:1] * t + nm[:, 1:2] * b + nm[:, 2:3] * n)
    return torch.where(has[:, None], n2, n)


# ----------------------------------------------------------------------------
# Fresnel
# ----------------------------------------------------------------------------

def fresnel_dielectric(cos_i, eta):
    """Exact dielectric Fresnel (unpolarized). cos_i >= 0, eta = n_t/n_i."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = torch.clamp(1.0 - cos_i * cos_i, min=0.0) / torch.clamp(eta * eta, min=1e-12)
    tir = sin2_t >= 1.0
    cos_t = sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-12)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))


# ----------------------------------------------------------------------------
# Lobe evaluation helpers (all non-delta)
# ----------------------------------------------------------------------------

def _orennayar_factor(rough, n, wo, wi, cos_o, cos_i):
    """Oren-Nayar qualitative model factor (sigma = rough in [0,1])."""
    sigma2 = rough * rough
    A = 1.0 - 0.5 * sigma2 / (sigma2 + 0.33)
    B = 0.45 * sigma2 / (sigma2 + 0.09)
    to = normalize3(wo - cos_o[..., None] * n)
    ti = normalize3(wi - cos_i[..., None] * n)
    cos_dphi = torch.clamp(dot3(to, ti), min=0.0)
    sin_a = sqrt(torch.clamp(1.0 - torch.minimum(cos_o, cos_i) ** 2, 0.0, 1.0))
    cmax = torch.maximum(cos_o, cos_i)
    tan_b = sqrt(torch.clamp(1.0 - cmax ** 2, 0.0, 1.0)) / torch.clamp(cmax, min=1e-4)
    return A + B * cos_dphi * sin_a * tan_b


def _ggx_d(cos_h, alpha):
    a2 = alpha * alpha
    d = cos_h * cos_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(PI * d * d, min=1e-12)


def _ggx_g1(cos_v, alpha):
    a2 = alpha * alpha
    return 2.0 * cos_v / torch.clamp(
        cos_v + sqrt(a2 + (1.0 - a2) * cos_v * cos_v), min=1e-12)


def _beckmann_d(cos_h, alpha):
    c2 = torch.clamp(cos_h * cos_h, min=1e-8)
    a2 = torch.clamp(alpha * alpha, min=1e-8)
    t2 = (1.0 - c2) / c2
    return torch.exp(-t2 / a2) / torch.clamp(PI * a2 * c2 * c2, min=1e-12)


def _lobe_weights(p: MatParams, wo, n):
    """Mixture probabilities (kd, ks, kt, kl) for one-sample lobe selection
    (diffuse / glossy-mirror / glass / translucent)."""
    cos_o = dot3(wo, n).abs()
    kd = luminance(p.diff_color)
    f_apx = torch.where(
        p.fresnel_on > 0.5,
        fresnel_dielectric(cos_o, torch.clamp(p.fresnel_ior, min=1.0 + 1e-4)), 1.0)
    ks = luminance(p.refl_color) * torch.where(
        p.fresnel_on > 0.5, torch.clamp(f_apx, min=0.1), 1.0)
    kt = luminance(p.transp_color)
    kl = luminance(p.transl_color)
    total = kd + ks + kt + kl
    safe = torch.clamp(total, min=EPS_PDF)
    return kd / safe, ks / safe, kt / safe, kl / safe, total


def _table_index(x, n):
    return torch.clamp((x * n - 0.5).to(torch.int64), 0, n - 1)


def _ggx_E(alpha, mu):
    E, _ = ET.ggx_tables(alpha.device)
    n = E.shape[0]
    return E[_table_index(alpha, n), _table_index(mu, n)]


def _ggx_E_avg(alpha):
    _, ea = ET.ggx_tables(alpha.device)
    return ea[_table_index(alpha, ea.shape[0])]


def _transp_ms_factor(alpha, mu, ior, color):
    """Pms = 1 + color*(1-Ess)/Ess (GetMultiscatteringFrom3dTable);
    identity outside the baked ior range."""
    E3 = ET.transp_table(alpha.device)
    n = E3.shape[0]
    zf = (ior - ET.TRANSP_IOR_MIN) / (ET.TRANSP_IOR_MAX - ET.TRANSP_IOR_MIN)
    Ess = torch.clamp(E3[_table_index(zf, n), _table_index(alpha, n),
                         _table_index(mu, n)], min=1e-3)
    pms = 1.0 + color * ((1.0 - Ess) / Ess)[..., None]
    in_range = (ior >= ET.TRANSP_IOR_MIN) & (ior <= ET.TRANSP_IOR_MAX)
    return torch.where(in_range[..., None], pms, 1.0)


def _aniso_frame(ns, rot):
    """Tangent frame for anisotropy, rotated by `rot` turns about ns."""
    t, b = make_orthonormal_basis(ns)
    c = torch.cos(2.0 * PI * rot)[..., None]
    sn = torch.sin(2.0 * PI * rot)[..., None]
    return c * t + sn * b, -sn * t + c * b


def _ggx_d_aniso(h, ns, t, b, ax, ay):
    hx = dot3(h, t)
    hy = dot3(h, b)
    hz = torch.clamp(dot3(h, ns), min=0.0)
    d = hx * hx / torch.clamp(ax * ax, min=1e-12) \
        + hy * hy / torch.clamp(ay * ay, min=1e-12) + hz * hz
    return 1.0 / torch.clamp(PI * ax * ay * d * d, min=1e-12)


def _eval_glossy(p: MatParams, wo, wi, ns, cos_o, cos_i, aniso=True,
                 mscomp=True):
    """Evaluate the (non-delta, reflective) glossy lobe: phong / ggx /
    beckmann. Returns (f (R,3), pdf (R,)) — zero for mirror/none."""
    h = normalize3(wo + wi)
    cos_h = torch.clamp(dot3(ns, h), min=0.0)
    cos_oh = torch.clamp(dot3(wo, h), min=1e-6)

    # phong
    r = reflect3(-wo, ns)
    cos_r = torch.clamp(dot3(r, wi), min=0.0)
    pw = p.refl_cospow
    phong_f = (pw + 2.0) * (0.5 * INV_PI) * torch.pow(cos_r, pw)
    phong_pdf = (pw + 1.0) * (0.5 * INV_PI) * torch.pow(cos_r, pw)

    # ggx (Smith separable G); anisotropic D when requested (TRGGX)
    d_ggx = _ggx_d(cos_h, p.refl_alpha)
    if aniso:
        ax = p.refl_alpha * (1.0 + p.refl_aniso)
        ay = p.refl_alpha * torch.clamp(1.0 - p.refl_aniso, min=1e-3)
        ta, ba = _aniso_frame(ns, p.refl_aniso_rot)
        d_an = _ggx_d_aniso(h, ns, ta, ba, ax, ay)
        d_ggx = torch.where(p.refl_aniso > 1e-3, d_an, d_ggx)
    g = _ggx_g1(cos_o, p.refl_alpha) * _ggx_g1(cos_i, p.refl_alpha)
    ggx_f = d_ggx * g / torch.clamp(4.0 * cos_o * cos_i, min=1e-6)
    # Kulla-Conty multiscatter compensation from the baked albedo table
    if mscomp:
        E_o = _ggx_E(p.refl_alpha, cos_o)
        E_i = _ggx_E(p.refl_alpha, torch.clamp(cos_i, min=1e-3))
        E_avg = _ggx_E_avg(p.refl_alpha)
        f_ms = (1.0 - E_o) * (1.0 - E_i) / torch.clamp(PI * (1.0 - E_avg), min=1e-3)
        ggx_f = ggx_f + torch.where(p.refl_alpha > 0.05, f_ms, 0.0)
    ggx_pdf = d_ggx * cos_h / (4.0 * cos_oh)

    # beckmann (ggx G as the shadowing approximation)
    d_b = _beckmann_d(cos_h, p.refl_alpha)
    b_f = d_b * g / torch.clamp(4.0 * cos_o * cos_i, min=1e-6)
    b_pdf = d_b * cos_h / (4.0 * cos_oh)

    dist = p.refl_dist
    f_scalar = torch.where(
        dist == REFL_PHONG, phong_f,
        torch.where(dist == REFL_GGX, ggx_f,
                    torch.where(dist == REFL_BECKMANN, b_f, 0.0)))
    pdf = torch.where(
        dist == REFL_PHONG, phong_pdf,
        torch.where(dist == REFL_GGX, ggx_pdf,
                    torch.where(dist == REFL_BECKMANN, b_pdf, 0.0)))
    fres = torch.where(
        p.fresnel_on > 0.5,
        fresnel_dielectric(cos_oh, torch.clamp(p.fresnel_ior, min=1.0 + 1e-4)),
        1.0)
    valid = (cos_i > 0.0) & (cos_o > 0.0) & (dist != REFL_MIRROR) & (dist != REFL_NONE)
    f = torch.where(valid[..., None], (f_scalar * fres)[..., None] * p.refl_color, 0.0)
    pdf = torch.where(valid, pdf, 0.0)
    return f, pdf


def eval_bsdf(p: MatParams, wo, wi, n, feats=FEATS_ALL):
    """Evaluate all non-delta lobes + mixture pdf (for NEE / MIS); ref
    materialEval (cmaterial.h:2554). Returns (f (R,3), pdf_fwd (R,))."""
    facing = dot3(n, wo) >= 0.0
    ns = torch.where(facing[..., None], n, -n)  # face the viewer
    cos_o = torch.clamp(dot3(ns, wo), min=0.0)
    cos_i = dot3(ns, wi)

    kd, ks, kt, kl, total = _lobe_weights(p, wo, ns)
    refl_side = cos_i > 0.0
    trans_side = cos_i < 0.0
    cos_i_pos = torch.clamp(cos_i, min=0.0)

    # diffuse
    on = _orennayar_factor(p.diff_rough, ns, wo, wi, cos_o, cos_i_pos)
    diff_factor = torch.where(p.diff_rough > 1e-5, on, 1.0)
    f_d = torch.where(refl_side[..., None],
                      p.diff_color * (INV_PI * diff_factor)[..., None], 0.0)
    pdf_d = torch.where(refl_side, cos_i_pos * INV_PI, 0.0)

    f_s, pdf_s = _eval_glossy(p, wo, wi, ns, cos_o, cos_i_pos,
                              aniso="aniso" in feats,
                              mscomp="mscomp" in feats)
    f_s = torch.where(refl_side[..., None], f_s, 0.0)
    pdf_s = torch.where(refl_side, pdf_s, 0.0)

    # translucency: Lambert transmission
    if "transl" in feats:
        f_l = torch.where(trans_side[..., None], p.transl_color * INV_PI, 0.0)
        pdf_l = torch.where(trans_side, cos_i.abs() * INV_PI, 0.0)
    else:
        f_l = torch.zeros_like(f_s)
        pdf_l = torch.zeros_like(pdf_s)

    if "glass" not in feats:
        alive = total > EPS_PDF
        f = torch.where(alive[..., None], f_d + f_s + f_l, 0.0)
        pdf = torch.where(alive, kd * pdf_d + ks * pdf_s + kl * pdf_l, 0.0)
        return f, pdf

    # rough glass: GGX microfacet transmission + reflection (Walter 2007).
    # Delta glass (alpha 0) stays a specular lobe handled by sample_bsdf.
    rough_glass = (p.transp_alpha > 1e-4) & (p.thin_walled == 0)
    eta = torch.where(facing, p.transp_ior,
                      1.0 / torch.clamp(p.transp_ior, min=1e-4))
    a_t = torch.clamp(p.transp_alpha, min=1e-3)
    ht = normalize3(-(wo + eta[..., None] * wi))
    ht = torch.where(dot3(ht, ns)[..., None] < 0.0, -ht, ht)
    woh_t = dot3(wo, ht)
    wih_t = dot3(wi, ht)
    F_t = fresnel_dielectric(woh_t.abs(), eta)
    d_t = _ggx_d(torch.clamp(dot3(ht, ns), min=0.0), a_t)
    g_t = _ggx_g1(cos_o, a_t) * _ggx_g1(cos_i.abs(), a_t)
    denom_t = woh_t + eta * wih_t
    jac_t = eta * eta * wih_t.abs() / torch.clamp(denom_t * denom_t, min=1e-9)
    f_gt_s = ((woh_t * wih_t).abs() / torch.clamp(cos_o * cos_i.abs(), min=1e-6)
              * eta * eta * (1.0 - F_t) * d_t * g_t
              / torch.clamp(denom_t * denom_t, min=1e-9))
    f_gt = torch.where((rough_glass & trans_side)[..., None],
                       p.transp_color * f_gt_s[..., None], 0.0)
    pdf_gt = torch.where(rough_glass & trans_side,
                         (1.0 - F_t) * d_t * torch.clamp(dot3(ht, ns), min=0.0)
                         * jac_t, 0.0)
    # glass reflection side (same lobe, F weight)
    hr = normalize3(wo + wi)
    woh_r = torch.clamp(dot3(wo, hr), min=1e-6)
    F_r = fresnel_dielectric(woh_r, eta)
    d_r = _ggx_d(torch.clamp(dot3(hr, ns), min=0.0), a_t)
    f_gr_s = d_r * g_t * F_r / torch.clamp(4.0 * cos_o * cos_i.abs(), min=1e-6)
    f_gr = torch.where((rough_glass & refl_side)[..., None],
                       p.transp_color * f_gr_s[..., None], 0.0)
    pdf_gr = torch.where(rough_glass & refl_side,
                         F_r * d_r * torch.clamp(dot3(hr, ns), min=0.0)
                         / (4.0 * woh_r), 0.0)

    # multiscatter compensation for rough glass (applied to f only; pdfs
    # stay single-scatter so MIS stays consistent)
    if "mscomp" in feats:
        pms = _transp_ms_factor(torch.clamp(p.transp_alpha, min=1e-3), cos_o,
                                eta, p.transp_color)
        pms = torch.where(rough_glass[..., None], pms, 1.0)
        f_gt = f_gt * pms
        f_gr = f_gr * pms

    alive = total > EPS_PDF
    f = torch.where(alive[..., None], f_d + f_s + f_l + f_gt + f_gr, 0.0)
    pdf = torch.where(alive, kd * pdf_d + ks * pdf_s + kl * pdf_l
                      + kt * (pdf_gt + pdf_gr), 0.0)
    return f, pdf


class BsdfSample(NamedTuple):
    wi: torch.Tensor  # (R,3)
    weight: torch.Tensor  # (R,3) f * |cos| / pdf  (full mixture)
    pdf: torch.Tensor  # (R,) mixture pdf (0 for delta)
    is_specular: torch.Tensor  # (R,) bool
    is_transmission: torch.Tensor  # (R,) bool
    is_diff_trans: torch.Tensor  # (R,) bool: translucency lobe picked


def _sample_microfacet_h(ns, cos_t, u2):
    t, b = make_orthonormal_basis(ns)
    sin_t = sqrt(torch.clamp(1.0 - cos_t * cos_t, 0.0, 1.0))
    phi = 2.0 * PI * u2
    return ((sin_t * torch.cos(phi))[..., None] * t
            + (sin_t * torch.sin(phi))[..., None] * b
            + cos_t[..., None] * ns)


def _sample_ggx_h(ns, alpha, u1, u2):
    t, b = make_orthonormal_basis(ns)
    a2 = alpha * alpha
    cos_t2 = (1.0 - u1) / torch.clamp(1.0 + (a2 - 1.0) * u1, min=1e-12)
    cos_t = sqrt(torch.clamp(cos_t2, 0.0, 1.0))
    sin_t = sqrt(torch.clamp(1.0 - cos_t2, 0.0, 1.0))
    phi = 2.0 * PI * u2
    return ((sin_t * torch.cos(phi))[..., None] * t
            + (sin_t * torch.sin(phi))[..., None] * b
            + cos_t[..., None] * ns)


def _sample_beckmann_h(ns, alpha, u1, u2):
    a2 = torch.clamp(alpha * alpha, min=1e-8)
    tan2 = -a2 * torch.log(torch.clamp(1.0 - u1, min=1e-12))
    cos_t = 1.0 / sqrt(1.0 + tan2)
    return _sample_microfacet_h(ns, cos_t, u2)


def _sample_phong_wi(r_dir, pw, u1, u2):
    cos_t = torch.pow(torch.clamp(1.0 - u1, min=1e-12), 1.0 / (pw + 1.0))
    return _sample_microfacet_h(r_dir, cos_t, u2)


def sample_bsdf(p: MatParams, wo, n, rands, feats=FEATS_ALL) -> BsdfSample:
    """One-sample-MIS lobe sampling. rands: (R,4) uniforms.

    Pick a lobe in proportion to its luminance, sample it, weight by the
    full mixture (f_total cos / pdf_total) for glossy + diffuse; delta lobes
    (mirror / glass) return weight = tint / lobe_prob with pdf = 0 and
    is_specular set so the caller uses MIS weight 1."""
    facing = dot3(n, wo) >= 0.0
    ns = torch.where(facing[..., None], n, -n)

    kd, ks, kt, kl, total = _lobe_weights(p, wo, ns)
    alive = total > EPS_PDF
    u_lobe = rands[:, 0]
    pick_d = u_lobe < kd
    pick_s = (~pick_d) & (u_lobe < kd + ks)
    pick_t = (~pick_d) & (~pick_s) & (u_lobe < kd + ks + kt) & alive
    pick_l = (~pick_d) & (~pick_s) & (~pick_t) & alive

    u1, u2, u3 = rands[:, 1], rands[:, 2], rands[:, 3]

    # --- diffuse: cosine hemisphere around ns
    t, b = make_orthonormal_basis(ns)
    ct = sqrt(torch.clamp(u1, 0.0, 1.0))
    st = sqrt(torch.clamp(1.0 - u1, 0.0, 1.0))
    phi = 2.0 * PI * u2
    wi_d = (st * torch.cos(phi))[..., None] * t \
        + (st * torch.sin(phi))[..., None] * b + ct[..., None] * ns

    # --- glossy reflection
    dist = p.refl_dist
    is_mirror = dist == REFL_MIRROR
    h_ggx = _sample_ggx_h(ns, p.refl_alpha, u1, u2)
    h_bec = _sample_beckmann_h(ns, p.refl_alpha, u1, u2)
    h = torch.where((dist == REFL_BECKMANN)[..., None], h_bec, h_ggx)
    wi_micro = reflect3(-wo, h)
    r_dir = reflect3(-wo, ns)
    wi_phong = _sample_phong_wi(r_dir, p.refl_cospow, u1, u2)
    wi_s = torch.where((dist == REFL_PHONG)[..., None], wi_phong, wi_micro)
    wi_s = torch.where(is_mirror[..., None], r_dir, wi_s)
    wi_s = normalize3(wi_s)

    # --- transparency (glass): microfacet half-vector when rough, the
    # shading normal itself when delta / thin-walled
    entering = facing
    if "glass" in feats:
        rough_glass = (p.transp_alpha > 1e-4) & (p.thin_walled == 0)
        h_glass = _sample_ggx_h(ns, torch.clamp(p.transp_alpha, min=1e-3), u1, u2)
        hh = torch.where(rough_glass[..., None], h_glass, ns)
        hh = torch.where(dot3(hh, wo)[..., None] < 0.0, ns, hh)  # degenerate
    else:
        rough_glass = torch.zeros_like(facing)
        hh = ns
    eta_pair = torch.where(entering, p.transp_ior,
                           1.0 / torch.clamp(p.transp_ior, min=1e-4))
    cos_i_o = torch.clamp(dot3(hh, wo), 0.0, 1.0)
    F = fresnel_dielectric(cos_i_o, eta_pair)
    thin = p.thin_walled > 0
    inv_eta = 1.0 / torch.clamp(eta_pair, min=1e-6)
    cos_t2 = 1.0 - inv_eta * inv_eta * (1.0 - cos_i_o * cos_i_o)
    tir = cos_t2 < 0.0
    cos_t = sqrt(torch.clamp(cos_t2, 0.0, 1.0))
    wt = normalize3((-inv_eta)[..., None] * wo
                    + (inv_eta * cos_i_o - cos_t)[..., None] * hh)
    refl_choice = (u3 < F) | tir
    wi_t = torch.where(refl_choice[..., None], reflect3(-wo, hh),
                       torch.where(thin[..., None], -wo, wt))

    # --- translucency: cosine hemisphere on the BACK side
    wi_l = -wi_d

    wi = torch.where(pick_d[..., None], wi_d,
                     torch.where(pick_s[..., None], wi_s,
                                 torch.where(pick_t[..., None], wi_t, wi_l)))

    spec = (pick_s & is_mirror) | (pick_t & ~rough_glass)
    is_transmission = (pick_t & ~refl_choice) | pick_l

    f_mix, pdf_mix = eval_bsdf(p, wo, wi, ns, feats)
    cos_i = dot3(ns, wi).abs()
    w_glossy = f_mix * (cos_i / torch.clamp(pdf_mix, min=EPS_PDF))[..., None]

    w_mirror = p.refl_color / torch.clamp(ks, min=EPS_PDF)[..., None]
    fres_m = torch.where(
        p.fresnel_on > 0.5,
        fresnel_dielectric(cos_i_o, torch.clamp(p.fresnel_ior, min=1.0 + 1e-4)),
        1.0)
    w_mirror = w_mirror * fres_m[..., None]
    w_glass = p.transp_color / torch.clamp(kt, min=EPS_PDF)[..., None]

    weight = torch.where(spec[..., None],
                         torch.where(pick_t[..., None], w_glass, w_mirror),
                         w_glossy)
    pdf = torch.where(spec, 0.0, pdf_mix)
    dead = ~(pick_d | pick_s | pick_t | pick_l)
    weight = torch.where(dead[..., None] | ~alive[..., None], 0.0, weight)

    return BsdfSample(wi=wi, weight=weight, pdf=pdf, is_specular=spec,
                      is_transmission=is_transmission, is_diff_trans=pick_l)
