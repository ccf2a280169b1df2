"""Procedural scene construction without a statefile: the JAX package's
SceneBuilder with the same recipe API, so the same recipe builds the same
bytes in both packages (tests/golden_scenes.py replays against either).

build() compiles on the host and returns a SceneData of CPU tensors; the
render entry points move it to their device. bench_scene() is the
full-size scene the chip smoke test renders.
"""
from __future__ import annotations

import numpy as np

from hydracore_tpu_torch.bvh.clusters import (CL_PART_CAP, cut_clusters,
                                              maybe_partition)
from hydracore_tpu_torch.bvh.native import build_bvh_auto
from hydracore_tpu_torch.scene.camera import build_camera
from hydracore_tpu_torch.scene.lights import (
    LIGHT_AREA_RECT,
    LIGHT_CYLINDER,
    LIGHT_POINT,
    LIGHT_SKY,
    LIGHT_SPHERE,
    LIGHT_MESH,
    LightTable,
    _blank as light_blank,
    compute_pick_cdf,
)
from hydracore_tpu_torch.scene.materials import MaterialTable, _blank_record
from hydracore_tpu_torch.scene.scene import (SceneData, build_mesh_light_tables,
                                             check_traversal, finalize_scene,
                                             part_cap_for, wide_pools)
from hydracore_tpu_torch.scene.statefile import CameraDesc, RenderSettings
from hydracore_tpu_torch.lights.envmap import build_env_pdf


class SceneBuilder:
    def __init__(self):
        self.tris = []  # list of (v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat, light)
        self.mat_recs: list[dict] = []
        self.light_recs: list[dict] = []
        self.env = np.zeros(3, np.float32)
        self.env_img = None

    # ---- materials
    def add_material(self, **kw) -> int:
        rec = _blank_record()
        rec.update(kw)
        self.mat_recs.append(rec)
        return len(self.mat_recs) - 1

    def lambert(self, color) -> int:
        return self.add_material(diff_color=np.asarray(color, np.float32))

    def emissive(self, radiance, light_id=-1) -> int:
        return self.add_material(em_color=np.asarray(radiance, np.float32), light_id=light_id)

    # ---- lights
    def add_light(self, **kw) -> int:
        rec = light_blank()
        rec.update(kw)
        self.light_recs.append(rec)
        return len(self.light_recs) - 1

    def sky(self, radiance, img: np.ndarray | None = None) -> int:
        self.env = np.asarray(radiance, np.float32)
        self.env_img = img
        return self.add_light(ltype=LIGHT_SKY, intensity=np.asarray(radiance, np.float32))

    def point_light(self, pos, intensity) -> int:
        return self.add_light(
            ltype=LIGHT_POINT, pos=np.asarray(pos, np.float32),
            intensity=np.asarray(intensity, np.float32),
        )

    def rect_light(self, center, hx, hz, radiance) -> int:
        """Rect at `center` in the XZ plane emitting down -Y with radiance."""
        vx = np.array([hx, 0, 0], np.float32)
        vy = np.array([0, 0, hz], np.float32)
        lid = self.add_light(
            ltype=LIGHT_AREA_RECT, pos=np.asarray(center, np.float32),
            norm=np.array([0, -1, 0], np.float32), vx=vx, vy=vy,
            intensity=np.asarray(radiance, np.float32), area=float(4 * hx * hz),
        )
        mat = self.emissive(radiance, light_id=lid)
        c = np.asarray(center, np.float32)
        quad = [c - vx - vy, c + vx - vy, c + vx + vy, c - vx + vy]
        self._quad(quad, np.array([0, -1, 0], np.float32), mat, light=lid)
        return lid

    def mesh_light(self, radiance) -> int:
        """Declare a mesh light; attach geometry by passing light=<id>
        (and an emissive material) to add_rect/add_sphere afterwards."""
        return self.add_light(ltype=LIGHT_MESH,
                              intensity=np.asarray(radiance, np.float32),
                              area=1.0)

    def sphere_light(self, center, radius, radiance) -> int:
        lid = self.add_light(
            ltype=LIGHT_SPHERE, pos=np.asarray(center, np.float32),
            intensity=np.asarray(radiance, np.float32), radius=float(radius),
            area=float(4 * np.pi * radius * radius),
        )
        mat = self.emissive(radiance, light_id=lid)
        self.add_sphere(center, radius, mat, light=lid)
        return lid

    def cylinder_light(self, center, half_height, radius, radiance,
                       n_seg: int = 24) -> int:
        """Cylinder light along +Y with emissive lateral-surface geometry
        (ref: PlainLightConverter.cpp:353 Cylinder)."""
        c = np.asarray(center, np.float32)
        axis = np.array([0, 1, 0], np.float32)
        lid = self.add_light(
            ltype=LIGHT_CYLINDER, pos=c, norm=axis,
            vx=axis * float(half_height), radius=float(radius),
            area=float(2 * np.pi * radius * (2 * half_height)),
            intensity=np.asarray(radiance, np.float32),
        )
        mat = self.emissive(radiance, light_id=lid)
        for s in range(n_seg):
            a0 = 2 * np.pi * s / n_seg
            a1 = 2 * np.pi * (s + 1) / n_seg
            r0 = np.array([np.cos(a0), 0, np.sin(a0)], np.float32)
            r1 = np.array([np.cos(a1), 0, np.sin(a1)], np.float32)
            p00 = c + radius * r0 - half_height * axis
            p10 = c + radius * r1 - half_height * axis
            p11 = c + radius * r1 + half_height * axis
            p01 = c + radius * r0 + half_height * axis
            n = (r0 + r1) / np.linalg.norm(r0 + r1)
            self._quad([p00, p10, p11, p01], n.astype(np.float32), mat,
                       light=lid)
        return lid

    # ---- geometry
    def _quad(self, pts, n, mat, light=-1, uvs=None):
        if uvs is None:
            uvs = [np.array(t, np.float32) for t in [(0, 0), (1, 0), (1, 1), (0, 1)]]
        for (i, j, k) in [(0, 1, 2), (0, 2, 3)]:
            self.tris.append(
                (pts[i], pts[j], pts[k], n, n, n, uvs[i], uvs[j], uvs[k], mat, light)
            )

    def add_rect(self, center, vx, vy, mat, light=-1, flip=False):
        """Rect spanned by half-axes vx, vy around center; normal = vx × vy."""
        c = np.asarray(center, np.float32)
        vx = np.asarray(vx, np.float32)
        vy = np.asarray(vy, np.float32)
        n = np.cross(vx, vy)
        n = n / max(np.linalg.norm(n), 1e-12)
        if flip:
            n = -n
        self._quad([c - vx - vy, c + vx - vy, c + vx + vy, c - vx + vy], n.astype(np.float32), mat, light)

    def add_sphere(self, center, radius, mat, light=-1, n_seg=32, n_ring=16):
        c = np.asarray(center, np.float32)
        for r in range(n_ring):
            th0 = np.pi * r / n_ring
            th1 = np.pi * (r + 1) / n_ring
            for s in range(n_seg):
                ph0 = 2 * np.pi * s / n_seg
                ph1 = 2 * np.pi * (s + 1) / n_seg

                def pt(th, ph):
                    n = np.array(
                        [np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)],
                        np.float32,
                    )
                    return c + radius * n, n

                p00, n00 = pt(th0, ph0)
                p01, n01 = pt(th0, ph1)
                p10, n10 = pt(th1, ph0)
                p11, n11 = pt(th1, ph1)
                uv = np.zeros(2, np.float32)
                if r > 0:
                    self.tris.append((p00, p11, p01, n00, n11, n01, uv, uv, uv, mat, light))
                if r < n_ring - 1:
                    self.tris.append((p00, p10, p11, n00, n10, n11, uv, uv, uv, mat, light))

    def add_box_interior(self, half, mat_floor, mat_ceil, mat_back, mat_left, mat_right):
        """Open-front cornell box centered at origin (normals point inward)."""
        h = float(half)
        ex = np.array([h, 0, 0], np.float32)
        ey = np.array([0, h, 0], np.float32)
        ez = np.array([0, 0, h], np.float32)
        self.add_rect([0, -h, 0], ex, ez, mat_floor, flip=True)  # floor, n=+y
        self.add_rect([0, h, 0], ex, ez, mat_ceil)  # ceiling, n=-y
        self.add_rect([0, 0, -h], ex, ey, mat_back)  # back, n=+z
        self.add_rect([-h, 0, 0], ey, ez, mat_left)  # left, n=+x
        self.add_rect([h, 0, 0], ey, ez, mat_right, flip=True)  # right, n=-x

    # ---- finalize
    def build(self, cam_pos, cam_lookat, fov=45.0, width=64, height=64,
              trace_depth=5, lens_radius=0.0,
              part_cap: int = CL_PART_CAP,
              traversal: str = "auto") -> SceneData:
        """Compile the recipe. A pool of more than `part_cap` clusters is
        partitioned into chunks of that many (bvh/clusters.py). `traversal`
        is the scene's static choice of traversal (ops/trace_api.py);
        "packet" and "wide" keep the cluster pool flat."""
        check_traversal(traversal, False)
        T = max(len(self.tris), 1)
        if not self.tris:
            self.tris.append(
                (np.full(3, 1e30, np.float32), np.full(3, 1e30, np.float32),
                 np.full(3, 1e30, np.float32), np.zeros(3, np.float32),
                 np.zeros(3, np.float32), np.zeros(3, np.float32),
                 np.zeros(2, np.float32), np.zeros(2, np.float32),
                 np.zeros(2, np.float32), 0, -1)
            )
        v0 = np.stack([t[0] for t in self.tris]).astype(np.float32)
        v1 = np.stack([t[1] for t in self.tris]).astype(np.float32)
        v2 = np.stack([t[2] for t in self.tris]).astype(np.float32)
        bvh = build_bvh_auto(v0, v1, v2)
        p = bvh.perm
        pools = wide_pools(bvh, v0[p], (v1 - v0)[p], (v2 - v0)[p])
        cl = maybe_partition(
            cut_clusters(bvh, v0[p], (v1 - v0)[p], (v2 - v0)[p]),
            part_cap_for(traversal, part_cap))

        pts = np.concatenate([v0, v1, v2], 0)
        wb_min = pts.min(0).astype(np.float32)
        wb_ext = np.maximum(pts.max(0) - pts.min(0), 1e-6).astype(np.float32)

        def g(i):
            return [self.tris[j][i] for j in p]

        if not self.mat_recs:
            self.lambert([0.5, 0.5, 0.5])
        if not self.light_recs:
            self.add_light()

        mats = _stack_materials(self.mat_recs)
        lights = _stack_lights(self.light_recs)

        tri_light_arr = np.asarray(g(10), np.int32)
        lights, ml_cdf, ml_tri = build_mesh_light_tables(
            lights, tri_light_arr, v0[p], (v1 - v0)[p], (v2 - v0)[p])

        cam = build_camera(
            CameraDesc(
                fov=fov,
                position=np.asarray(cam_pos, np.float32),
                look_at=np.asarray(cam_lookat, np.float32),
                enable_dof=lens_radius > 0,
                dof_lens_radius=lens_radius,
            ),
            width, height,
        )
        settings = RenderSettings(
            width=width, height=height, trace_depth=trace_depth,
            has_alpha=any(r["opacity_tex"] != 0 for r in self.mat_recs),
            has_blend=any(r["blend_node"] >= 0 for r in self.mat_recs),
            has_rough_glass=any(r["transp_gloss"] < 0.999
                                and max(r["transp_color"]) > 0
                                for r in self.mat_recs),
            has_transl=any(max(r["transl_color"]) > 0 for r in self.mat_recs),
            has_aniso=any(r["refl_aniso"] > 1e-3 for r in self.mat_recs),
            has_ms_comp=any((r["refl_dist"] in (2, 3)
                             and r["refl_alpha"] > 0.05)
                            or (float(np.max(r["transp_color"])) > 0
                                and float(r["transp_gloss"]) < 0.999)
                            for r in self.mat_recs),
        )
        texels = np.ones((1, 4), np.float32)
        tex_table = np.array([[0, 1, 1, 0]], np.int32)
        tex_sampler = np.array([[1, 0, 0, 0, 1, 0, 1.0, 0]], np.float32)

        env_img = self.env_img if self.env_img is not None else np.ones((8, 16, 4), np.float32)
        env_rows, env_cols, env_pdf = build_env_pdf(env_img)
        if self.env_img is not None:
            raise NotImplementedError("textures (sky image)")

        n0_arr = np.stack(g(3)).astype(np.float32)
        # procedural meshes carry no authored tangents: derive a stable
        # per-vertex frame (Frisvad) from the normal
        def frisvad(n):
            sign = np.where(n[:, 2] >= 0, 1.0, -1.0)
            a = -1.0 / (sign + n[:, 2])
            b = n[:, 0] * n[:, 1] * a
            return np.stack([1.0 + sign * n[:, 0] ** 2 * a, sign * b, -sign * n[:, 0]], -1).astype(np.float32)

        return finalize_scene(SceneData(
            tri_v0=v0[p], tri_e1=(v1 - v0)[p], tri_e2=(v2 - v0)[p],
            n0=n0_arr,
            n1=np.stack(g(4)).astype(np.float32),
            n2=np.stack(g(5)).astype(np.float32),
            t0=frisvad(n0_arr),
            t1=frisvad(np.stack(g(4)).astype(np.float32)),
            t2=frisvad(np.stack(g(5)).astype(np.float32)),
            uv0=np.stack(g(6)).astype(np.float32),
            uv1=np.stack(g(7)).astype(np.float32),
            uv2=np.stack(g(8)).astype(np.float32),
            tri_mat=np.asarray(g(9), np.int32),
            tri_light=np.asarray(g(10), np.int32),
            tri_inst=np.zeros(T, np.int32),
            cl_bounds=cl.bounds_lane, cl_tris=cl.tris,
            cl_slot_tri=cl.slot_tri, cl_oct_perm=cl.oct_perm,
            cl_bounds_oct=cl.bounds_oct,
            world_bmin=wb_min, world_bext=wb_ext,
            ml_cdf=ml_cdf, ml_tri=ml_tri,
            materials=mats, lights=lights,
            texels=texels, tex_table=tex_table, tex_sampler=tex_sampler,
            camera=cam, env_color=self.env,
            env_rows_cdf=env_rows, env_cols_cdf=env_cols, env_pdf_uv=env_pdf,
            settings=settings, traversal=traversal, **pools,
        ))


def _stack_materials(recs) -> MaterialTable:
    def stack(key, dtype):
        return np.asarray([r[key] for r in recs], dtype)

    return MaterialTable(
        em_color=stack("em_color", np.float32), em_tex=stack("em_tex", np.int32),
        diff_color=stack("diff_color", np.float32), diff_tex=stack("diff_tex", np.int32),
        diff_rough=stack("diff_rough", np.float32),
        refl_color=stack("refl_color", np.float32), refl_tex=stack("refl_tex", np.int32),
        refl_gloss=stack("refl_gloss", np.float32), refl_cospow=stack("refl_cospow", np.float32),
        refl_alpha=stack("refl_alpha", np.float32), refl_dist=stack("refl_dist", np.int32),
        fresnel_ior=stack("fresnel_ior", np.float32), fresnel_on=stack("fresnel_on", np.float32),
        transp_color=stack("transp_color", np.float32), transp_gloss=stack("transp_gloss", np.float32),
        transp_ior=stack("transp_ior", np.float32), thin_walled=stack("thin_walled", np.int32),
        fog_color=stack("fog_color", np.float32), fog_mult=stack("fog_mult", np.float32),
        opacity_tex=stack("opacity_tex", np.int32), skip_shadow=stack("skip_shadow", np.int32),
        light_id=stack("light_id", np.int32), diff_proc=stack("diff_proc", np.int32),
        bump_tex=stack("bump_tex", np.int32), bump_amount=stack("bump_amount", np.float32),
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


def _stack_lights(recs) -> LightTable:
    def stack(key, dtype):
        return np.asarray([r[key] for r in recs], dtype)

    cdf = compute_pick_cdf(recs)

    return LightTable(
        mesh_row=stack("mesh_row", np.int32),
        is_portal=stack("is_portal", np.int32),
        ltype=stack("ltype", np.int32), pos=stack("pos", np.float32),
        norm=stack("norm", np.float32), vx=stack("vx", np.float32),
        vy=stack("vy", np.float32), intensity=stack("intensity", np.float32),
        radius=stack("radius", np.float32), area=stack("area", np.float32),
        cos_in=stack("cos_in", np.float32), cos_out=stack("cos_out", np.float32),
        tex=stack("tex", np.int32), pick_cdf=cdf,
        statefile_id=np.arange(len(recs), dtype=np.int32),
    )


def bench_builder(n_seg: int = 160, n_ring: int = 80) -> SceneBuilder:
    """Recipe of the full-size test scene: the golden cornell box (diffuse
    walls, red and green sides, one rect light) holding a rough GGX sphere
    of 25,280 triangles (about the 25.6k of the reference's test_224 teapot
    scene) and a small delta-glass sphere of 960 — 26,252 triangles, a flat
    pool of a few hundred clusters. A finer tessellation of the large
    sphere (n_seg x n_ring) makes the big-scene variant: 450 x 225 gives
    201,600 triangles there and a pool partitioned into chunks."""
    b = SceneBuilder()
    m = b.lambert([0.65, 0.65, 0.65])
    red = b.lambert([0.7, 0.12, 0.1])
    green = b.lambert([0.12, 0.55, 0.18])
    b.add_box_interior(2.0, m, m, m, red, green)
    ggx = b.add_material(refl_color=np.array([0.8, 0.7, 0.5], np.float32),
                         refl_dist=2, refl_alpha=0.25, refl_gloss=0.75)
    b.add_sphere([-0.6, -1.1, -0.4], 0.9, ggx, n_seg=n_seg, n_ring=n_ring)
    glass = b.add_material(transp_color=np.array([0.95, 0.95, 0.95], np.float32),
                           transp_gloss=1.0, transp_ior=1.5)
    b.add_sphere([0.9, -1.5, 0.7], 0.5, glass)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [12.0] * 3)
    return b


def bench_scene(width: int = 1024, height: int = 1024, trace_depth: int = 5,
                builder: SceneBuilder | None = None,
                part_cap: int = CL_PART_CAP,
                traversal: str = "auto") -> SceneData:
    """Build the full-size test scene (bench_builder's recipe unless a
    builder is given) behind its camera."""
    b = builder if builder is not None else bench_builder()
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0],
                   width=width, height=height, trace_depth=trace_depth,
                   part_cap=part_cap, traversal=traversal)
