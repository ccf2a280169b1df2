"""Texture storage, host side: one flat texel buffer + id->record table.

The port's own copy of the JAX package's scene/textures.py as far as scene
assembly needs it: every texture's texels live in ONE float32 (X, 4)
buffer; a small (num_tex, 4) int32 table holds [texel_offset, width,
height, flags]. With no textures the heap is the single white texel of
slot 0. ops/texture.py fetches from it.

Deviations from the reference, by design:
 - LDR textures are linearized (input gamma 2.2) at LOAD time instead of at
   fetch (SWTexSampler carries per-sampler gamma, cfetch.h:108-131).

Memory budgeting: fit_texture_res mirrors FitTextureRes
(RenderDriverRTE.cpp:565-650 + AllocAll :604): when the packed heap would
exceed the budget, the heaviest texture is halved (box filter, <=3 times
each = mip 4) until common + bump pools fit their budgets.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from hydracore_tpu_torch.scene.statefile import SceneDesc, parse_floats

FLAG_LDR = 1


def _load_image4ub(data: bytes) -> np.ndarray:
    w, h = struct.unpack_from("<ii", data, 0)
    px = np.frombuffer(data, np.uint8, count=w * h * 4, offset=8)
    return px.reshape(h, w, 4).astype(np.float32) / 255.0


def _load_image4f(data: bytes) -> np.ndarray:
    w, h = struct.unpack_from("<ii", data, 0)
    px = np.frombuffer(data, np.float32, count=w * h * 4, offset=8)
    return px.reshape(h, w, 4)


def load_texture_array(desc: SceneDesc, tid: int) -> np.ndarray | None:
    t = desc.textures.get(tid)
    if t is None or not t.loc:
        return None
    if getattr(t, "proc_name", None):
        return None  # procedural: loc points at the .c SOURCE, not texels
    path = os.path.join(desc.lib_dir, t.loc)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    if t.loc.endswith("image4f"):
        return _load_image4f(data)
    # LDR stays raw: per-sampler input gamma is applied at fetch
    # (SWTexSampler.gamma, cfetch.h:108-131)
    return _load_image4ub(data)


# tex_table flags (SWTexSampler flags analogue)
TEX_CLAMP_U = 1
TEX_CLAMP_V = 2

# default texture heap budgets, bytes of f32 RGBA texels (AllocAll's
# memForTex/memForTex2 defaults, RenderDriverRTE.cpp:604-650). 1 GiB common
# + 256 MiB bump at 16 B/texel = 64M + 16M texels.
TEX_MEM_BUDGET = 1 << 30
TEX_MEM_BUDGET_BUMP = 256 << 20
_BYTES_PER_TEXEL = 16  # float32 RGBA

def downscale2x(img: np.ndarray) -> np.ndarray:
    """Half-resolution box filter (the reference's texture resize step)."""
    h, w = img.shape[:2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    img = img[: h2 * 2, : w2 * 2]
    if h >= 2 and w >= 2:
        return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                       + img[0::2, 1::2] + img[1::2, 1::2])
    return img[:h2, :w2]


def fit_texture_res(imgs: dict, is_bump: dict,
                    budget: int = TEX_MEM_BUDGET,
                    budget_bump: int = TEX_MEM_BUDGET_BUMP) -> dict:
    """FitTextureRes (RenderDriverRTE.cpp:565): iteratively halve the
    HEAVIEST texture of the over-budget pool (≤3 halvings each — max mip
    level 4) until both pools fit. imgs: {tid: ndarray}; is_bump: {tid:
    bool}. Returns possibly-downscaled {tid: ndarray} and logs resizes."""
    halved: dict[int, int] = {t: 0 for t in imgs}

    def pool_bytes(bump: bool) -> int:
        return sum(im.shape[0] * im.shape[1] * _BYTES_PER_TEXEL
                   for t, im in imgs.items() if is_bump.get(t, False) == bump)

    def heaviest(bump: bool) -> int:
        best, best_sz = -1, 0
        for t, im in imgs.items():
            if is_bump.get(t, False) != bump or halved[t] >= 3:
                continue
            sz = im.shape[0] * im.shape[1]
            if sz > best_sz and min(im.shape[:2]) >= 2:
                best, best_sz = t, sz
        return best

    for bump, cap in ((False, budget), (True, budget_bump)):
        while pool_bytes(bump) > cap:
            t = heaviest(bump)
            if t < 0:
                break
            h, w = imgs[t].shape[:2]
            imgs[t] = downscale2x(imgs[t])
            halved[t] += 1
            print(f"[scene] texture {t} downscaled {w}x{h} -> "
                  f"{imgs[t].shape[1]}x{imgs[t].shape[0]} (mem budget)")
    return imgs


class TextureStorage:
    """Host-side packed texture heap; `.texels` / `.table` / `.samplers`
    go into the scene. Samplers carry the 2-row texcoord matrix + input gamma
    (SWTexSampler, cfetch.h:108-131); flags carry clamp/wrap addressing."""

    def __init__(self):
        self._chunks: list[np.ndarray] = []
        self._table: list[tuple[int, int, int, int]] = []
        self._samplers: list[tuple] = []
        self._offset = 0
        # slot 0 = 1x1 white fallback so tex_id 0 (or missing) is benign
        self.add(np.ones((1, 1, 4), np.float32))

    def add(self, img: np.ndarray, matrix=None, flags: int = 0,
            gamma: float = 1.0) -> int:
        h, w = img.shape[:2]
        flat = np.ascontiguousarray(img.reshape(-1, 4), np.float32)
        self._chunks.append(flat)
        self._table.append((self._offset, w, h, flags))
        if matrix is None:
            row = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, gamma, 0.0)
        else:
            m = np.asarray(matrix, np.float32)
            row = (float(m[0, 0]), float(m[0, 1]), float(m[0, 3]),
                   float(m[1, 0]), float(m[1, 1]), float(m[1, 3]),
                   gamma, 0.0)
        self._samplers.append(row)
        self._offset += flat.shape[0]
        return len(self._table) - 1

    def set_sampler(self, slot: int, matrix, flags: int, gamma: float):
        m = np.asarray(matrix, np.float32)
        self._samplers[slot] = (float(m[0, 0]), float(m[0, 1]), float(m[0, 3]),
                                float(m[1, 0]), float(m[1, 1]), float(m[1, 3]),
                                gamma, 0.0)
        off, w, h, _ = self._table[slot]
        self._table[slot] = (off, w, h, flags)

    def finalize(self):
        texels = np.concatenate(self._chunks, axis=0)
        table = np.asarray(self._table, np.int32)
        samplers = np.asarray(self._samplers, np.float32)
        # bake per-sampler input gamma into the texels (one sampler per
        # texture here, so the bake is exact) — keeps the per-fetch gamma
        # path dormant and the fetch cost at round-1 levels
        for slot in range(len(self._table)):
            g = samplers[slot, 6]
            if g != 1.0:
                off, w, h, _ = self._table[slot]
                texels[off:off + w * h, :3] = \
                    np.maximum(texels[off:off + w * h, :3], 0.0) ** g
                samplers[slot, 6] = 1.0
        return texels, table, samplers


def _height_to_normalmap(height: np.ndarray, amount: float) -> np.ndarray:
    """Numpy Sobel height -> tangent-space normal map, stored remapped to
    [0,1] (ref: NormalmapFromHeight, shaders/image.cl:37)."""
    h = height

    def sh(dy, dx):
        return np.roll(h, (dy, dx), axis=(0, 1))

    gx = (sh(-1, -1) + 2 * sh(0, -1) + sh(1, -1)
          - sh(-1, 1) - 2 * sh(0, 1) - sh(1, 1)) / 8.0
    gy = (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1)
          - sh(1, -1) - 2 * sh(1, 0) - sh(1, 1)) / 8.0
    n = np.stack([gx * amount, gy * amount, np.ones_like(h)], -1)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    out = np.ones(h.shape + (4,), np.float32)
    out[..., :3] = n * 0.5 + 0.5
    return out


def bake_aux_normalmaps(desc: SceneDesc, storage: "TextureStorage",
                        fitted: dict | None = None) -> dict:
    """Convert height_bump displacement maps to normal-map texture slots —
    the aux-texture pass of the reference (RenderDriverRTE_AuxTextures.cpp
    GetAuxNormalMapFromDisaplacement, cached per (mat, tex)).
    fitted: budget-fitted source images (fit_texture_res) so baked maps
    honor the aux budget. Returns {material_id: slot}."""
    slots: dict[int, int] = {}
    cache: dict[tuple, int] = {}
    for mid, node in desc.materials.items():
        displ = node.find("displacement")
        if displ is None or displ.get("type") != "height_bump":
            continue
        hm = displ.find("height_map")
        t = hm.find("texture") if hm is not None else None
        if t is None:
            continue
        tid = int(t.get("id", -1))
        amount = float(hm.get("amount", 1.0))
        key = (tid, amount)
        if key not in cache:
            img = fitted.get(tid) if fitted is not None else None
            if img is None:
                img = load_texture_array(desc, tid)
            if img is None:
                continue
            height = img[..., :3].mean(-1)
            cache[key] = storage.add(_height_to_normalmap(height, amount))
        slots[mid] = cache[key]
    return slots


def bake_ies_textures(desc: SceneDesc, storage: "TextureStorage") -> dict:
    """Load IES photometric profiles referenced by lights into spherical
    intensity textures (ref IESRender.cpp CreateSphericalTextureFromIES).
    Returns {light_id: slot}."""
    from hydracore_tpu_torch.lights.ies import load_ies_texture

    slots: dict[int, int] = {}
    for lid, node in desc.lights.items():
        ies = node.find("ies")
        path = None
        if ies is not None:
            path = ies.get("data") or ies.get("loc")
        if not path:
            continue
        full = path if os.path.isabs(path) else os.path.join(desc.lib_dir, path)
        if not os.path.exists(full):
            continue
        try:
            tex, _peak = load_ies_texture(full)
        except Exception:
            continue
        slots[lid] = storage.add(tex)
    return slots


def build_texture_storage(desc: SceneDesc, budget: int = TEX_MEM_BUDGET,
                          budget_bump: int = TEX_MEM_BUDGET_BUMP):
    """Pack every scene texture (+ baked aux normal maps + IES profiles);
    returns (texels, table, samplers, id_remap, bump_slots, ies_slots).
    Textures are budget-fitted first (fit_texture_res)."""
    storage = TextureStorage()
    max_id = max(desc.textures.keys(), default=-1)
    remap = np.zeros(max(max_id + 2, 1), np.int32)  # default white
    is_ldr = {}

    # displacement height sources count against the bump/aux budget
    # (AllocAll splits memForTex / memForTex2, RenderDriverRTE.cpp:647)
    bump_src = set()
    for node in desc.materials.values():
        displ = node.find("displacement")
        if displ is not None:
            for t in displ.iter("texture"):
                bump_src.add(int(t.get("id", -1)))

    imgs: dict[int, np.ndarray] = {}
    for tid in sorted(desc.textures.keys()):
        img = load_texture_array(desc, tid)
        if img is not None:
            imgs[tid] = img
    imgs = fit_texture_res(imgs, {t: t in bump_src for t in imgs},
                           budget, budget_bump)

    for tid in sorted(desc.textures.keys()):
        img = imgs.get(tid)
        if img is None:
            remap[tid] = 0
        else:
            # LDR color textures default to input gamma 2.2 (the loader no
            # longer pre-linearizes); overridden by the first XML binding
            ldr = not (desc.textures[tid].loc or "").endswith("image4f")
            is_ldr[tid] = ldr
            remap[tid] = storage.add(img, gamma=2.2 if ldr else 1.0)

    # first XML binding per texture wins: texcoord matrix, addressing
    # flags, input gamma (SWTexSampler semantics; a one-sampler-per-
    # texture simplification of per-binding samplers)
    bound = set()
    for node in desc.materials.values():
        for t in node.iter("texture"):
            tid = int(t.get("id", -1))
            if tid < 0 or tid >= len(remap) or tid in bound or remap[tid] == 0:
                continue
            bound.add(tid)
            mat_attr = t.get("matrix")
            m = (np.asarray(parse_floats(mat_attr), np.float32).reshape(4, 4)
                 if mat_attr else np.eye(4, dtype=np.float32))
            flags = 0
            if (t.get("addressing_mode_u") or "wrap") == "clamp":
                flags |= TEX_CLAMP_U
            if (t.get("addressing_mode_v") or "wrap") == "clamp":
                flags |= TEX_CLAMP_V
            g = float(t.get("input_gamma", 2.2 if is_ldr.get(tid) else 1.0))
            storage.set_sampler(int(remap[tid]), m, flags, g)

    bump_slots = bake_aux_normalmaps(desc, storage, imgs)
    ies_slots = bake_ies_textures(desc, storage)
    texels, table, samplers = storage.finalize()
    return texels, table, samplers, remap, bump_slots, ies_slots
