"""The G-buffer and adaptive sampling in the port (integrators/gbuffer.py)
against the JAX package on the same scenes and seeds.

Tolerances:
  * float layers (depth, normal, texcolor, coverage, shadow, alpha,
    depth_center) and images: >= 99% of pixels within 1e-3 (the image rule
    of tests/test_torch_pt.py; the eye rays and the camera inverse differ by
    ulps, so a subsample on an edge may land on the other side);
    depth_center is +inf on the same pixels;
  * id layers (mat_id, inst_id): equal on >= 99% of pixels (the dominant
    subsample may flip on an edge);
  * noise_map: rtol 1e-6.

The JAX G-buffer runs eagerly (jax.disable_jit, _jax_gbuffer): under jit
XLA:CPU contracts the dense triangle test into FMAs, which moves equal-t
ties where two walls of the box meet (8 of 576 pixels of the normal layer
move between the JAX package's own jitted and eager runs); the port rounds
each operation, as the eager run does. The instanced case calls it as it
stands (its traversal jitted), where the eager run takes twice as long; its
scene has no such ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.textured_scenes as ts
from hydracore_tpu.integrators import gbuffer as jgb
from hydracore_tpu.scene import scene as jscene
from hydracore_tpu.scene.procedural import SceneBuilder
from hydracore_tpu_torch.integrators import gbuffer as tgb
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.scene import scene as pscene
from tests.test_torch_assemble import JAX, PORT, make_desc, xform
from tests.test_torch_scene import to_port

torch.set_num_threads(1)

FLOAT_LAYERS = ("depth", "normal", "texcolor", "coverage", "shadow", "alpha",
                "depth_center")
ID_LAYERS = ("mat_id", "inst_id")


def _box_scene():
    """tests/test_lt_gbuffer.py's box."""
    b = SceneBuilder()
    m = b.lambert([0.65, 0.65, 0.65])
    red = b.lambert([0.7, 0.1, 0.1])
    b.add_box_interior(2.0, m, m, m, red, m)
    b.rect_light([0, 1.95, 0], 0.6, 0.6, [12.0, 12.0, 12.0])
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=24,
                   height=24, trace_depth=4)


@pytest.fixture(scope="module")
def box():
    js = _box_scene()
    return js, to_port(js)


def _jax_gbuffer(js, seed, n_samples=4):
    with jax.disable_jit():
        return jgb.eval_gbuffer(js, jnp.uint32(seed), n_samples=n_samples)


def _pixels(x):
    x = np.asarray(x)
    return x[..., None] if x.ndim == 2 else x


def _layer_close(a, b) -> float:
    a, b = _pixels(a).astype(np.float64), _pixels(b).astype(np.float64)
    same_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    ok = same_inf | (np.abs(np.where(same_inf, 0.0, a)
                            - np.where(same_inf, 0.0, b)) <= 1e-3)
    return float(ok.all(-1).mean())


def _same_layers(gp, gj, what):
    assert sorted(gp) == sorted(gj)
    for k in FLOAT_LAYERS:
        a, b = gp[k].cpu().numpy(), np.asarray(gj[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        close = _layer_close(a, b)
        assert close >= 0.99, f"{what} {k}: {close}"
    for k in ID_LAYERS:
        a, b = gp[k].cpu().numpy(), np.asarray(gj[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        same = float((a == b).mean())
        assert same >= 0.99, f"{what} {k}: {same}"


def test_gbuffer_matches_jax_box(box):
    js, ps = box
    gj = _jax_gbuffer(js, 7)
    gp = tgb.eval_gbuffer(ps, 7, n_samples=4, device="cpu")
    _same_layers(gp, gj, "box")
    # tests/test_lt_gbuffer.py's sanity checks on the port's layers
    assert 3.0 < float(gp["depth"][12, 12]) < 9.0
    assert float(gp["normal"][12, 12, 2]) > 0.9
    assert float(gp["coverage"].mean()) > 0.95
    assert 0.3 < float(gp["shadow"].mean()) <= 1.0
    assert int(gp["mat_id"].max()) >= 0


@pytest.mark.parametrize("traversal", ["auto", "cluster"])
def test_gbuffer_matches_jax_alpha(traversal):
    """An opacity-mapped scene: the shadow layer walks the transparent
    layers (on the port's cluster route B2's twin over the opaque pool plus
    the dense alpha set), the alpha layer reads the opacity maps."""
    js = ts.alpha("jax")
    ps = to_port(js, traversal=traversal)
    assert ps.settings.has_alpha
    gj = _jax_gbuffer(js, 5)
    gp = tgb.eval_gbuffer(ps, 5, n_samples=4, device="cpu")
    _same_layers(gp, gj, f"alpha {traversal}")
    alpha = gp["alpha"][gp["coverage"] > 0]
    assert float(alpha.min()) < 0.999  # the maps are seen
    assert 0.0 < float(gp["shadow"].mean()) < 1.0


def test_gbuffer_instanced_equals_flattened():
    """The instanced layout of tests/test_torch_instanced.py's SceneDesc
    (the plane, a single-use mesh, in the flattened world, row 0; five
    boxes and a mirrored one as instances) against its flattened assembly:
    every layer, inst_id the original desc.instances index in both. (The
    extended desc's mesh lights list their triangles in each layout's own
    triangle order, in both packages, so the same uniforms pick another
    triangle of the light in each layout: its shadow layer differs by
    layout, an equally valid sample. ROADMAP.md §C.)"""
    def desc():
        d = make_desc(PORT, False, 32)
        d.instances.append(PORT[0].InstanceDesc(
            mesh_id=2, matrix=xform(-4.5, 0.3, 3.0, 0.8, 0.4, sx=-1.5)))
        return d

    inst = pscene.assemble(desc(), instancing="force")
    flat = pscene.assemble(desc(), instancing="off")
    assert inst.settings.has_inst and not flat.settings.has_inst
    assert int(inst.inst_orig[0]) == -1 and inst.inst_orig.numel() == 7
    gi = tgb.eval_gbuffer(inst, 11, n_samples=4, device="cpu")
    gf = tgb.eval_gbuffer(flat, 11, n_samples=4, device="cpu")
    _same_layers(gi, {k: v.numpy() for k, v in gf.items()}, "instanced")
    ids = set(np.unique(gi["inst_id"].numpy()).tolist())
    # misses, the plane (flattened world) and the six boxes (instances)
    assert ids == {-1, 0, 1, 2, 3, 4, 5, 6}, ids


def test_gbuffer_instanced_matches_jax():
    """The instanced layout of the same SceneDesc assembled by both
    packages, 16x16, two subsamples (the centre and a jittered one): the
    id mapping of an instanced hit (cl_slot_tri2 -> inst_orig, tri_inst for
    the flattened world) against the JAX package's. Each subsample costs
    the JAX package several seconds here, hence two."""
    def desc(pk):
        d = make_desc(pk, False, 16)
        d.instances.append(pk[0].InstanceDesc(
            mesh_id=2, matrix=xform(-4.5, 0.3, 3.0, 0.8, 0.4, sx=-1.5)))
        return d

    js = jscene.assemble(desc(JAX), instancing="force")
    ps = pscene.assemble(desc(PORT), instancing="force")
    assert js.settings.has_inst and ps.settings.has_inst
    gj = jgb.eval_gbuffer(js, jnp.uint32(11), n_samples=2)
    gp = tgb.eval_gbuffer(ps, 11, n_samples=2, device="cpu")
    _same_layers(gp, gj, "instanced")
    ids = set(np.unique(gp["inst_id"].numpy()).tolist())
    assert ids == {-1, 0, 1, 2, 3, 4, 5, 6}, ids


def test_noise_map_matches_jax():
    rng = np.random.default_rng(3)
    s = rng.uniform(0.0, 4.0, (12, 10, 3)).astype(np.float32)
    s2 = (s * s / 3.0 + rng.uniform(0.0, 1.0, s.shape)).astype(np.float32)
    for n in (0.5, 3.0, 16.0):
        nj = np.asarray(jgb.noise_map(jnp.asarray(s), jnp.asarray(s2), n))
        np_ = tgb.noise_map(torch.tensor(s), torch.tensor(s2), n).numpy()
        assert np_.shape == (12, 10)
        np.testing.assert_allclose(np_, nj, rtol=1e-6, atol=1e-12)


def test_render_adaptive_matches_jax(box, monkeypatch):
    """24x24, tiles of 256 pixels. The base pass takes rounds of K =
    min(spp_base, 32) samples and its noise is the spread between rounds,
    so spp_base 33 (two rounds of 32) is the least that can mark a pixel
    noisy; those get one more round (spp_max 40). The noisy set is not a
    whole number of tiles, so its last id is padded in and the duplicates
    add up (and are counted) in both packages."""
    js, ps = box
    kw = dict(spp_base=33, spp_max=40, seed=3, noise_threshold=0.1,
              tile_pixels=256)
    img_j = jgb.render_adaptive(js, **kw)
    maps = []
    noise_map = tgb.noise_map
    monkeypatch.setattr(tgb, "noise_map",
                        lambda *a: maps.append(noise_map(*a)) or maps[-1])
    img_p = tgb.render_adaptive(ps, device="cpu", **kw)
    assert img_p.dtype == np.float32 and img_p.shape == (24, 24, 3)
    assert np.isfinite(img_p).all() and img_p.mean() > 0.01
    assert _layer_close(img_p, img_j) >= 0.99
    # one noise map, of the two base rounds; the top-up set pads with
    # duplicates
    assert len(maps) == 1
    noisy = int((maps[0] > kw["noise_threshold"]).sum())
    assert 0 < noisy and noisy % 256 != 0


def test_render_adaptive_one_round_marks_nothing(box):
    """spp_base <= 32 is one base round, whose spread is zero: no pixel is
    topped up, so the image is the production render of spp_base (the JAX
    package's behaviour, kept)."""
    _, ps = box
    img = tgb.render_adaptive(ps, 8, 16, seed=3, noise_threshold=0.1,
                              tile_pixels=256, device="cpu")
    ref = tpt.render_production(ps, 8, seed=3, tile_pixels=256, device="cpu")
    assert _layer_close(img, ref.numpy()) == 1.0


def test_gbuffer_entry_points_need_cuda(box):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, ps = box
    with pytest.raises(RuntimeError, match="CUDA"):
        tgb.eval_gbuffer(ps, 7, n_samples=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgb.render_adaptive(ps, 1, 2, tile_pixels=64)
