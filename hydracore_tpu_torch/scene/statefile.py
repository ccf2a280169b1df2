"""Parser for HydraAPI scene-library "statefiles" (statex_*.xml + chunks).

The statefile is a concatenation of XML libraries (textures_lib,
materials_lib, lights_lib, cam_lib, geometry_lib, render_lib, scenes) — not
a single-root document, so we wrap it before parsing. Binary payloads live
in sibling chunk files referenced by `loc` attributes.

Reference behavior: the HydraAPI master writes these files and drives
RenderDriverRTE's Update* callbacks from them (SURVEY.md intro + §3.1);
here we ingest the same on-disk format directly into host-side descriptors
which the compilers in materials.py / lights.py / scene.py flatten into
device tables. This is the port's own copy of the JAX package's
scene/statefile.py (pure numpy and XML): the same library gives the same
SceneDesc in both packages.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

from hydracore_tpu_torch.scene.vsgf import MeshData, load_vsgf, make_rect_mesh


# ----------------------------------------------------------------------------
# XML helpers
# ----------------------------------------------------------------------------

def _text_or_val(node) -> str | None:
    if node is None:
        return None
    v = node.get("val")
    if v is not None:
        return v
    return node.text


def parse_floats(s: str | None, default=None):
    if s is None:
        return default
    s = s.replace(",", " ").strip()
    # tolerate trailing 'f' suffixes like "0.25f"
    toks = [t.rstrip("fF") for t in s.split()]
    return [float(t) for t in toks if t]


def get_float(parent, tag, default=0.0) -> float:
    v = _text_or_val(parent.find(tag)) if parent is not None else None
    if v is None:
        return float(default)
    vals = parse_floats(v)
    return float(vals[0]) if vals else float(default)


def get_color(parent, tag, default=(0.0, 0.0, 0.0)):
    v = _text_or_val(parent.find(tag)) if parent is not None else None
    vals = parse_floats(v)
    if not vals:
        return np.asarray(default, np.float32)
    if len(vals) == 1:
        vals = vals * 3
    return np.asarray(vals[:3], np.float32)


def get_tex_id(parent) -> int:
    if parent is None:
        return -1
    t = parent.find("texture")
    if t is None:
        return -1
    return int(t.get("id", -1))


# ----------------------------------------------------------------------------
# Descriptors
# ----------------------------------------------------------------------------

@dataclass
class TextureDesc:
    id: int
    name: str
    loc: str | None  # chunk path relative to lib dir
    offset: int
    bytesize: int
    is_hdr: bool = False
    proc_name: str | None = None  # `type="proc"` textures: stdlib key
    proc_main: str | None = None  # prtexN main symbol from <code main=…>
    # proc-tex AO input channel (<ao hemisphere=… length=… local=…>,
    # ReadAOFromNode, RenderDriverRTE_ProcTex.cpp:290-320)
    ao_type: int = 0  # 0 none / 1 up / 2 down / 3 both
    ao_length: float = 0.0
    # <code><generated><arg> layout: [(name, type, woffset, wsize), ...] —
    # maps shader parameters onto the material arg stack (proctex_c)
    gen_args: list | None = None


@dataclass
class CameraDesc:
    fov: float = 45.0
    near: float = 0.01
    far: float = 100.0
    position: np.ndarray = field(default_factory=lambda: np.array([0, 0, 15], np.float32))
    look_at: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    dof_lens_radius: float = 0.0
    enable_dof: bool = False
    focal_dist: float = -1.0  # <0: distance |look_at - position|
    # tabulated optical system (<optical_system type="tabular">, the
    # reference camera plugin's multi-lens tables — CamHostPluginAPI.h):
    # list of dicts(curvature_radius, thickness, ior, aperture_radius) in
    # scene_to_sensor order + the sensor diagonal in the same length units
    optics: list | None = None
    sensor_diagonal: float = 0.035


@dataclass
class RenderSettings:
    width: int = 512
    height: int = 512
    trace_depth: int = 5
    diff_trace_depth: int = 3
    max_rays_per_pixel: int = 256
    method: str = "pathtracing"  # pathtracing | lighttracing | IBPT | SBDPT | MMLT
    qmc_variant: int = 7
    clamp: float = 1e6
    # --- UpdateSettings parity (RenderDriverRTE.cpp:160-397) ---
    seed: int = 777  # <seed> (m_legacy.m_lastSeed)
    min_rays_per_pixel: int = 0  # <minRaysPerPixel> adaptive-stop floor
    pt_error: float = 0.025  # HRT_PATH_TRACE_ERROR (xml value is in %: *0.01)
    out_gamma: float = 2.2  # <outgamma> -> HRT_IMAGE_GAMMA
    offline_pt: bool = False  # <offline_pt> -> HRT_PRODUCTION_IMAGE_SAMPLING
    boxmode: bool = False  # <boxmode> -> HRT_BOX_MODE_ON
    contrib_samples: int = 0  # <contribsamples> -> HRT_CONTRIB_SAMPLES
    fb_channels: int = 4  # <framebuffer_channels> -> HRT_FBUF_CHANNELS
    pt_caustics: bool = True  # method_caustic != none -> HRT_ENABLE_PT_CAUSTICS
    # render-layer separation (HRT_DIRECT_LIGHT_MODE / HRT_INDIRECT_LIGHT_MODE
    # kill rules, material.cl:547-551 + :953-955): direct + indirect == color
    render_layer: str = "color"  # color | direct | indirect
    evalgbuffer: bool = False  # <evalgbuffer> -> HRT_STORE_SHADOW_COLOR_W
    mmlt_burn_iters: int = 1024  # <mmlt_burn_iters>
    mmlt_step_power: float = 1024.0  # <mmlt_step_power> large|(normal)|small
    mmlt_step_size: float = 1.0  # <mmlt_step_size> -> HRT_MMLT_STEP_SIZE_COEFF
    mmlt_sds_fixed_prob: float = 0.0  # <mmlt_sds_fixed_prob> (clamped 0..0.95)
    # -double_rt / the reference's -D DOUBLE_RAY_TRIANGLE compile variant
    # (GPUOCLLayer.cpp:695-700): hit REFINEMENT (final Möller–Trumbore +
    # alpha/dense paths) runs in float64; cluster selection stays f32 —
    # a correctness option for precision-adversarial scenes.
    double_rt: bool = False
    has_alpha: bool = False  # any material with an opacity texture
    has_blend: bool = False  # any blend material (two-leaf fetch at shade)
    has_rough_glass: bool = False
    has_transl: bool = False
    has_aniso: bool = False
    has_ms_comp: bool = False  # any rough-GGX material (multiscatter table)
    # static feature gates set by scene.finalize_scene — the integrator
    # skips the code paths of absent light/texture features (the
    # reference's per-scene kernel variants, GPUOCLKernels.cpp:424-512).
    # Defaults are permissive (True) so hand-built scenes stay correct.
    light_types: tuple = tuple(range(9))  # LIGHT_* values present
    has_sky: bool = True
    has_ies: bool = True
    has_portal: bool = True
    has_mesh_light: bool = True
    has_em_tex: bool = True
    has_diff_tex: bool = True
    has_refl_tex: bool = True
    has_transl_tex: bool = True
    has_proc_tex: bool = True
    has_bump: bool = True
    has_sss: bool = False  # any subsurface-scattering material
    has_fog: bool = False  # any glass with Beer fog (fog_multiplier > 0)
    has_proc_ao: bool = False  # any proc-tex with an AO input channel
    blend_depth: int = 1  # deepest blend-tree chain in the scene
    has_inst: bool = False  # two-level instanced layout (bvh/instanced.py)
    has_env_back: bool = False  # sky <back> plate (scene.env_back row)


@dataclass
class InstanceDesc:
    mesh_id: int
    matrix: np.ndarray  # (4,4) float32 row-major
    light_id: int = -1  # >=0: this instance is an area-light emitter
    linst_id: int = -1
    remap_list: np.ndarray | None = None  # flat [from0,to0,from1,to1,...]


@dataclass
class LightInstanceDesc:
    light_id: int
    matrix: np.ndarray


@dataclass
class SceneDesc:
    lib_dir: str
    textures: dict[int, TextureDesc]
    materials: dict[int, ET.Element]
    lights: dict[int, ET.Element]
    camera: CameraDesc
    settings: RenderSettings
    meshes: dict[int, MeshData]
    mesh_light_id: dict[int, int]  # mesh id -> light id (light meshes)
    instances: list[InstanceDesc]
    light_instances: list[LightInstanceDesc]


# ----------------------------------------------------------------------------
# Loading
# ----------------------------------------------------------------------------

def _wrap_multiroot_xml(text: str) -> ET.Element:
    text = re.sub(r"<\?xml[^>]*\?>", "", text)
    return ET.fromstring("<statefile>" + text + "</statefile>")


def _latest_statefile(lib_dir: str) -> str:
    cands = sorted(
        f for f in os.listdir(lib_dir) if f.startswith("statex_") and f.endswith(".xml")
    )
    if not cands:
        raise FileNotFoundError(f"no statex_*.xml in {lib_dir}")
    return os.path.join(lib_dir, cands[-1])


def _parse_camera(root) -> CameraDesc:
    cam = CameraDesc()
    cam_lib = root.find("cam_lib")
    if cam_lib is None:
        return cam
    c = cam_lib.find("camera")
    if c is None:
        return cam
    cam.fov = get_float(c, "fov", 45.0)
    cam.near = get_float(c, "nearClipPlane", 0.01)
    cam.far = get_float(c, "farClipPlane", 100.0)
    cam.position = np.asarray(parse_floats(_text_or_val(c.find("position")), [0, 0, 15])[:3], np.float32)
    cam.look_at = np.asarray(parse_floats(_text_or_val(c.find("look_at")), [0, 0, 0])[:3], np.float32)
    cam.up = np.asarray(parse_floats(_text_or_val(c.find("up")), [0, 1, 0])[:3], np.float32)
    cam.enable_dof = int(get_float(c, "enable_dof", 0)) != 0
    cam.dof_lens_radius = get_float(c, "dof_lens_radius", 0.0)
    osys = c.find("optical_system")
    if osys is not None and (osys.get("type") or "").lower() == "tabular":
        cam.sensor_diagonal = float(osys.get("sensor_diagonal", 0.035))
        cam.optics = [
            dict(curvature_radius=float(ln.get("curvature_radius", 0.0)),
                 thickness=float(ln.get("thickness", 0.0)),
                 ior=float(ln.get("ior", 1.0)),
                 aperture_radius=float(ln.get("aperture_radius",
                                              ln.get("semi_diameter", 1.0))))
            for ln in osys.findall("line")]
    return cam


def _parse_settings(root) -> RenderSettings:
    s = RenderSettings()
    rl = root.find("render_lib")
    if rl is None:
        return s
    rs = rl.find("render_settings")
    if rs is None:
        return s
    s.width = int(get_float(rs, "width", s.width))
    s.height = int(get_float(rs, "height", s.height))
    s.trace_depth = int(get_float(rs, "trace_depth", s.trace_depth))
    s.diff_trace_depth = int(get_float(rs, "diff_trace_depth", s.diff_trace_depth))
    s.max_rays_per_pixel = int(get_float(rs, "maxRaysPerPixel", s.max_rays_per_pixel))
    s.qmc_variant = int(get_float(rs, "qmc_variant", s.qmc_variant))
    m = rs.find("method_primary")
    if m is not None and m.text:
        s.method = m.text.strip()
    # --- UpdateSettings parity (RenderDriverRTE.cpp:160-397) ---
    s.clamp = get_float(rs, "clamping", s.clamp)
    s.seed = int(get_float(rs, "seed", s.seed))
    s.min_rays_per_pixel = int(get_float(rs, "minRaysPerPixel",
                                         s.min_rays_per_pixel))
    pe = rs.find("pt_error")  # xml value is a percentage (ref: 0.01f * v)
    if pe is not None and pe.text:
        s.pt_error = 0.01 * float(pe.text.strip())
    s.out_gamma = get_float(rs, "outgamma", s.out_gamma)
    s.offline_pt = int(get_float(rs, "offline_pt", 0)) != 0
    s.boxmode = int(get_float(rs, "boxmode", 0)) != 0
    s.contrib_samples = int(get_float(rs, "contribsamples", 0))
    s.fb_channels = int(get_float(rs, "framebuffer_channels", s.fb_channels))
    s.evalgbuffer = int(get_float(rs, "evalgbuffer", 0)) != 0
    # method_secondary == mmlt/mlt overrides the primary method; a disabled
    # method_caustic turns PT caustic transport off (HRT_ENABLE_PT_CAUSTICS)
    ms = rs.find("method_secondary")
    if ms is not None and ms.text and ms.text.strip().lower() in ("mmlt", "mlt"):
        s.method = "mmlt"
    mc = rs.find("method_caustic")
    if mc is not None and mc.text and mc.text.strip().lower() in ("none",
                                                                  "disabled"):
        s.pt_caustics = False
    s.mmlt_burn_iters = int(get_float(rs, "mmlt_burn_iters",
                                      s.mmlt_burn_iters))
    sp = rs.find("mmlt_step_power")
    if sp is not None and sp.text:
        s.mmlt_step_power = {"large": 512.0, "small": 2048.0}.get(
            sp.text.strip().lower(), 1024.0)
    s.mmlt_step_size = get_float(rs, "mmlt_step_size", s.mmlt_step_size)
    s.mmlt_sds_fixed_prob = min(max(get_float(rs, "mmlt_sds_fixed_prob",
                                              s.mmlt_sds_fixed_prob), 0.0),
                                0.95)
    return s


def load_statefile(lib_dir: str, statefile: str | None = None) -> SceneDesc:
    """Load a scene library directory (the `-inputlib` argument of the
    reference CLI, hydra_app/input.cpp)."""
    if statefile:  # -statefile: a name inside the library, or a full path
        path = statefile if os.path.isabs(statefile) \
            else os.path.join(lib_dir, statefile)
    else:
        path = _latest_statefile(lib_dir)
    with open(path, "r", errors="replace") as f:
        root = _wrap_multiroot_xml(f.read())

    # --- textures
    textures: dict[int, TextureDesc] = {}
    tl = root.find("textures_lib")
    if tl is not None:
        for t in tl.findall("texture"):
            tid = int(t.get("id"))
            loc = t.get("loc")
            td = TextureDesc(
                id=tid,
                name=t.get("name", ""),
                loc=loc,
                offset=int(t.get("offset", 0)),
                bytesize=int(t.get("bytesize", 0)),
                is_hdr=bool(loc and loc.endswith("image4f")),
            )
            if t.get("type") == "proc":
                # procedural texture declaration (RenderDriverRTE_ProcTex
                # codegen source); materials bind it with `texref_proc`
                # nodes carrying the arg stack
                td.proc_name = td.name
                code = t.find("code")
                if code is not None:
                    td.proc_main = code.get("main")
                    td.loc = code.get("loc") or loc
                    gen = code.find("generated")
                    if gen is not None:
                        td.gen_args = [
                            (a.get("name", ""), a.get("type", "float"),
                             int(a.get("woffset", 0)),
                             int(a.get("wsize", 1)))
                            for a in gen.findall("arg")]
                        # prtexN_main symbol from the <call> line when the
                        # attribute only says "main"
                        call = gen.find("call")
                        if call is not None and call.text:
                            sym = call.text.strip().split("(", 1)[0]
                            if sym:
                                td.proc_main = sym
                ao = t.find("ao")
                if ao is not None:
                    hemi = (ao.get("hemisphere") or "").lower()
                    td.ao_type = {"up": 1, "corner": 1, "down": 2,
                                  "edge": 2, "both": 3}.get(hemi, 0)
                    td.ao_length = float(ao.get("length", 0.0))
            textures[tid] = td

    # --- materials / lights: keep the XML nodes; compilers interpret them
    materials = {}
    ml = root.find("materials_lib")
    if ml is not None:
        for m in ml.findall("material"):
            materials[int(m.get("id"))] = m
    lights = {}
    ll = root.find("lights_lib")
    if ll is not None:
        for l in ll.findall("light"):
            lights[int(l.get("id"))] = l

    # --- geometry
    meshes: dict[int, MeshData] = {}
    mesh_light_id: dict[int, int] = {}
    gl = root.find("geometry_lib")
    if gl is not None:
        for m in gl.findall("mesh"):
            mid = int(m.get("id"))
            if m.get("light_id") is not None:
                mesh_light_id[mid] = int(m.get("light_id"))
            loc = m.get("loc")
            chunk_path = os.path.join(lib_dir, loc) if loc else None
            if chunk_path and os.path.exists(chunk_path):
                xml_arrays = {}
                for child in m:
                    if child.get("offset") is not None and child.get("bytesize") is not None:
                        xml_arrays[child.tag] = (
                            int(child.get("offset")),
                            int(child.get("bytesize")),
                        )
                with open(chunk_path, "rb") as f:
                    f.seek(int(m.get("offset", 0)))
                    data = f.read(int(m.get("bytesize", os.path.getsize(chunk_path))))
                meshes[mid] = load_vsgf(data, xml_arrays)
            # else: missing chunk (delayed-load mesh absent from repo copy) —
            # instances referencing it are skipped by the assembler.

    # --- scene instances (last <scene> wins, matching latest-state semantics)
    instances: list[InstanceDesc] = []
    light_instances: list[LightInstanceDesc] = []
    scenes = root.find("scenes")
    if scenes is not None and len(scenes):
        scene = scenes.findall("scene")[-1]
        for node in scene:
            if node.tag == "instance":
                mat = np.asarray(parse_floats(node.get("matrix")), np.float32).reshape(4, 4)
                rl_attr = node.get("rmap_lists") or node.get("remap_lists")
                remap = None
                if rl_attr:
                    remap = np.asarray(parse_floats(rl_attr), np.int32)
                instances.append(
                    InstanceDesc(
                        mesh_id=int(node.get("mesh_id")),
                        matrix=mat,
                        light_id=int(node.get("light_id", -1)),
                        linst_id=int(node.get("linst_id", -1)),
                        remap_list=remap,
                    )
                )
            elif node.tag == "instance_light":
                light_instances.append(
                    LightInstanceDesc(
                        light_id=int(node.get("light_id")),
                        matrix=np.asarray(parse_floats(node.get("matrix")), np.float32).reshape(4, 4),
                    )
                )

    # Synthesize light meshes that are referenced by instances but whose
    # chunks are missing: area rect lights have analytic geometry.
    for inst in instances:
        mid = inst.mesh_id
        if mid in meshes:
            continue
        lid = inst.light_id if inst.light_id >= 0 else mesh_light_id.get(mid, -1)
        if lid >= 0 and lid in lights:
            lnode = lights[lid]
            if lnode.get("type") == "area" and lnode.get("shape", "rect") == "rect":
                size = lnode.find("size")
                hl = float(size.get("half_length", 1.0)) if size is not None else 1.0
                hw = float(size.get("half_width", 1.0)) if size is not None else 1.0
                mat_id = int(lnode.get("mat_id", 0))
                meshes[mid] = make_rect_mesh(hl, hw, mat_id)

    return SceneDesc(
        lib_dir=lib_dir,
        textures=textures,
        materials=materials,
        lights=lights,
        camera=_parse_camera(root),
        settings=_parse_settings(root),
        meshes=meshes,
        mesh_light_id=mesh_light_id,
        instances=instances,
        light_instances=light_instances,
    )
