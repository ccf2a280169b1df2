"""Texture fetch from the packed heap (torch): bilinear RGBA through index
gathers, the analogue of the reference's SWTexSampler + read_imagef
(cfetch.h).

The JAX package's ops/texture.py, 4-corner fetch only. A texture's
sampler row carries the 2-row texcoord matrix and the input gamma; its
table flags carry clamp or wrap addressing per axis. The (R, 12) meta rows
are [bitcast_f32(off, w, h, flags) | m00 m01 tu m10 m11 tv gamma pad], as
materials carry them baked in (scene.finalize_scene).

The JAX package also has a (X, 16) quad-heap layout (one gathered row per
fetch) that it takes when the heap is small enough: a TPU gather layout,
not ported. Under clamp addressing with x0 < 0 it returns the corner texel
where the 4-corner fetch forms c*(1-fx) + c*fx, a 1-ulp difference; fetches
agree with the JAX package to rtol 1e-6, not bit for bit.
"""
from __future__ import annotations

import torch

TEX_CLAMP_U = 1
TEX_CLAMP_V = 2


def _bilinear(texels, off, w, h, flags, u_in, v_in):
    """Bilinear RGBA at texcoords (u_in, v_in) of the textures whose
    [off, w, h, flags] are given per ray: one gather of the 4R corners."""
    wf, hf = w.to(torch.float32), h.to(torch.float32)
    clamp_u = (flags & TEX_CLAMP_U) != 0
    clamp_v = (flags & TEX_CLAMP_V) != 0
    u = torch.where(clamp_u, torch.clamp(u_in, 0.0, 1.0),
                    u_in - torch.floor(u_in))
    v = torch.where(clamp_v, torch.clamp(v_in, 0.0, 1.0),
                    v_in - torch.floor(v_in))
    x = u * wf - 0.5
    y = v * hf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    w64, h64 = w.to(torch.int64), h.to(torch.int64)

    def wrap(i, n, clamp):
        i = i.to(torch.int64)
        return torch.where(clamp, torch.minimum(torch.clamp(i, min=0), n - 1),
                           torch.remainder(i, torch.clamp(n, min=1)))

    xa, xb = wrap(x0, w64, clamp_u), wrap(x0 + 1, w64, clamp_u)
    ya, yb = wrap(y0, h64, clamp_v), wrap(y0 + 1, h64, clamp_v)
    off = off.to(torch.int64)
    idx = torch.cat([off + ya * w64 + xa, off + ya * w64 + xb,
                     off + yb * w64 + xa, off + yb * w64 + xb])
    c = texels[idx].reshape(4, -1, 4)
    top = c[0] * (1 - fx) + c[1] * fx
    bot = c[2] * (1 - fx) + c[3] * fx
    return top * (1 - fy) + bot * fy


def _gamma(out, gamma):
    rgb = torch.where((gamma != 1.0)[:, None],
                      torch.pow(torch.clamp(out[:, :3], min=0.0),
                                gamma[:, None]),
                      out[:, :3])
    return torch.cat([rgb, out[:, 3:4]], dim=1)


def sample_tex_row(texels, row, uv, apply_gamma: bool = False):
    """Bilinear RGBA fetch (R, 4) given the (R, 12) meta rows: texcoords
    through the row's 2-row matrix, then clamp or wrap per axis."""
    meta_i = row[:, 0:4].contiguous().view(torch.int32)
    off, w, h, flags = meta_i.unbind(dim=1)
    u_in = row[:, 4] * uv[:, 0] + row[:, 5] * uv[:, 1] + row[:, 6]
    v_in = row[:, 7] * uv[:, 0] + row[:, 8] * uv[:, 1] + row[:, 9]
    out = _bilinear(texels, off, w, h, flags, u_in, v_in)
    return _gamma(out, row[:, 10]) if apply_gamma else out


def tex_fetch_row(scene, row, uv, apply_gamma: bool = False):
    """sample_tex_row over the scene's texel heap."""
    return sample_tex_row(scene.texels, row, uv, apply_gamma)


def tex_fetch_rows_batch(scene, rows_list, uv, apply_gamma: bool = False):
    """K channel fetches at the same uv through one stacked (K*R) fetch;
    equal to K tex_fetch_row calls."""
    if len(rows_list) == 1:
        return [tex_fetch_row(scene, rows_list[0], uv, apply_gamma)]
    rows = torch.cat(rows_list, dim=0)
    uvk = torch.cat([uv] * len(rows_list), dim=0)
    out = tex_fetch_row(scene, rows, uvk, apply_gamma)
    R = uv.shape[0]
    return [out[i * R:(i + 1) * R] for i in range(len(rows_list))]


def tex_fetch(scene, tex_id, uv, apply_gamma: bool = False):
    """Bilinear fetch by texture slot id (R,) through the tex_meta rows."""
    n = scene.tex_meta.shape[0]
    row = scene.tex_meta[torch.clamp(tex_id.long(), 0, n - 1)]
    return tex_fetch_row(scene, row, uv, apply_gamma)


def sample_bilinear(texels, tex_table, tex_id, uv, samplers=None,
                    apply_gamma: bool = False):
    """Bilinear RGBA fetch from the unbaked tables: texels (X, 4), tex_table
    (K, 4) int32 [offset, w, h, flags], tex_id (R,) slot (0 = white), uv
    (R, 2); samplers, optional (K, 8) [m00 m01 tu m10 m11 tv gamma 0].
    Returns (R, 4) (gamma-linearized rgb when samplers are given and
    apply_gamma). Nothing in the port calls it yet: the JAX package's one
    caller is the light tracer's IES lookup (sample_light_fwd), which the
    port does not carry; it is kept at parity with the JAX version, which
    the tests hold it to."""
    rec = tex_table[tex_id.long()]
    off, w, h, flags = rec.unbind(dim=1)
    u_in, v_in = uv[:, 0], uv[:, 1]
    gamma = None
    if samplers is not None:
        sm = samplers[tex_id.long()]
        u_in = sm[:, 0] * uv[:, 0] + sm[:, 1] * uv[:, 1] + sm[:, 2]
        v_in = sm[:, 3] * uv[:, 0] + sm[:, 4] * uv[:, 1] + sm[:, 5]
        gamma = sm[:, 6]
    out = _bilinear(texels, off, w, h, flags, u_in, v_in)
    if gamma is not None and apply_gamma:
        out = _gamma(out, gamma)
    return out
