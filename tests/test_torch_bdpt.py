"""Bidirectional path tracing in the port: integrators/bdpt.py against the
JAX package's on the same inputs.

The JAX side runs eagerly (jax.disable_jit()): under jit XLA:CPU contracts
the dense triangle test into FMAs and moves equal-t ties on the box's
edges (tests/test_torch_gbuffer.py), and one eager run per scene costs
less than a compile. Its full and 3-way runs share their subpaths (the
test hands the second run the first run's vertices; both sets of
strategies read the same subpaths).

Tolerances:
  * the helpers (_remap1, _to_area, cam_pdf_w, project_to_screen,
    light_emit_pdf_w) and _mis_weight on synthetic pf/pl/spec vectors:
    equal masks (on-screen lanes, pixels), values at rtol 1e-6 (_to_area:
    of pdf_w / d^2, its size before the cosine, since XLA's rsqrt is not
    correctly rounded); a deep path whose absolute pdf products overflow
    float32 gives finite weights;
  * the subpath vertices (trace_camera_subpath, trace_light_subpath):
    every float field at rtol 1e-5, atol 1e-6 on the lanes where it is
    defined; valid, spec, is_env and hittable equal;
  * the per-strategy images of _bdpt_core(with_labels=True): the same
    label set, each image by the image rule (>= 99% of pixels within 1e-3,
    tests/test_torch_pt.py) and its total energy within rtol 1e-4, for
    "full" and "3way" on the port's auto route and on its cluster route
    (B1/B2's twins through the sorted calls); k_only= and lane_k= alike;
  * render_bdpt / render_ibpt: the mean of their passes within rtol 1e-6.

tests/test_torch_bdpt_oracle.py holds the sky scenes and the oracle,
tests/test_torch_bdpt_scenes.py the glossy box and a textured recipe (each
file pays the JAX package's eager warm-up, about 20 s, once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore_tpu.integrators import bdpt as jb
from hydracore_tpu.integrators.pt import _morton_pixel_order, make_eye_rays
from hydracore_tpu.ops import rng as jrng
from hydracore_tpu_torch.integrators import bdpt as tb
from tests.test_bdpt import _cornell
from tests.test_torch_scene import to_port

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
PASS, SEED, DEPTH = 3, 41, 3


def _close(a, b) -> float:
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1)
                  <= 1e-3).mean())


def jax_wavefront(js, pass_idx, seed):
    """The JAX package's eye wavefront of one pass (bdpt_pass_impl's):
    (ray_o, ray_d, rand_fn, pix)."""
    cam = js.camera
    W, H = cam.width, cam.height
    R = W * H
    pix = jnp.asarray(_morton_pixel_order(W, H))
    sample_idx = pix * jnp.uint32(0x9E3779B9) ^ (
        jnp.uint32(pass_idx) * jnp.uint32(0x85EBCA6B))

    def rand_fn(depth, group):
        return jrng.rand4(sample_idx, depth, group, jnp.uint32(seed))

    jitter = jrng.screen_sample(jnp.broadcast_to(jnp.uint32(pass_idx), (R,)),
                                pix)
    lens = jrng.rand2(sample_idx, 0, jb.DG_BD_LENS, jnp.uint32(seed))
    ray_o, ray_d = make_eye_rays(cam, (pix % W).astype(jnp.int32),
                                 (pix // W).astype(jnp.int32), jitter, lens)
    return ray_o, ray_d, rand_fn, pix


def jax_strategies(js, pass_idx=PASS, seed=SEED, max_depth=DEPTH,
                   strategies=("full", "3way"), **kw):
    """Eager JAX _bdpt_core(with_labels=True) for each strategy set over one
    set of subpaths: ({strategies: {(s, t): (H, W, 3) image}}, subpaths
    {"cam": zs, "light": (y0, ys)})."""
    W, H = js.camera.width, js.camera.height
    R = W * H
    subpaths = {}
    saved = jb.trace_camera_subpath, jb.trace_light_subpath

    def once(key, fn):
        def call(*a, **k):
            if key not in subpaths:
                subpaths[key] = fn(*a, **k)
            return subpaths[key]
        return call

    out = {}
    jb.trace_camera_subpath = once("cam", saved[0])
    jb.trace_light_subpath = once("light", saved[1])
    try:
        with jax.disable_jit():
            ray_o, ray_d, rand_fn, pix = jax_wavefront(js, pass_idx, seed)
            for strat in strategies:
                imgs = {}
                for lbl, flat, amt in jb._bdpt_core(
                        js, ray_o, ray_d, rand_fn, pix.astype(jnp.int32),
                        jnp.float32(R), max_depth, strat, with_labels=True,
                        **kw):
                    img = jnp.zeros((R, 3), jnp.float32).at[flat].add(
                        amt, mode="drop")
                    imgs[(int(lbl[0]), int(lbl[1]))] = np.asarray(
                        img).reshape(H, W, 3)
                out[strat] = imgs
    finally:
        jb.trace_camera_subpath, jb.trace_light_subpath = saved
    return out, subpaths


def port_strategies(ps, strategy, pass_idx=PASS, seed=SEED,
                    max_depth=DEPTH, **kw):
    """The port's _bdpt_core(with_labels=True) images on the CPU, k_only=
    and lane_k= passed through."""
    W, H = ps.camera.width, ps.camera.height
    R = W * H
    ray_o, ray_d, rand_fn, pix, _ = tb._eye_wavefront(ps, [pass_idx],
                                                        seed)
    out = {}
    for lbl, flat, amt in tb._bdpt_core(ps, ray_o, ray_d, rand_fn, pix,
                                        float(R), max_depth, strategy,
                                        with_labels=True, **kw):
        img = torch.zeros((R, 3), dtype=torch.float32)
        out[lbl] = img.index_add_(0, flat, amt).reshape(H, W, 3).numpy()
    return out


def same_images(ref: dict, got: dict, what: str) -> None:
    """The same labels; each image by the image rule, its energy within
    rtol 1e-4."""
    assert sorted(got) == sorted(ref), (what, sorted(got), sorted(ref))
    for lbl, a in ref.items():
        b = got[lbl]
        assert np.isfinite(b).all(), (what, lbl)
        close = _close(a, b)
        assert close >= 0.99, (what, lbl, close)
        e_a, e_b = a.sum(dtype=np.float64), b.sum(dtype=np.float64)
        assert abs(e_b - e_a) <= 1e-4 * abs(e_a) + 1e-7, (what, lbl, e_a, e_b)


# ---------------------------------------------------------------------------
# Helpers and the MIS walk on synthetic inputs
# ---------------------------------------------------------------------------

def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_helpers_match_jax():
    js = _cornell()
    ps = to_port(js)
    assert tb.INV_PI == jb.INV_PI
    assert (tb.DG_BD_LENS, tb.DG_BD_CAM_BSDF, tb.DG_BD_LGT_EMIT,
            tb.DG_BD_LGT_BSDF, tb.DG_BD_BLEND) == (
        jb.DG_BD_LENS, jb.DG_BD_CAM_BSDF, jb.DG_BD_LGT_EMIT,
        jb.DG_BD_LGT_BSDF, jb.DG_BD_BLEND)
    assert tb.HITTABLE_TYPES == jb.HITTABLE_TYPES
    rng = np.random.default_rng(5)
    n = 4096
    x = rng.normal(size=n).astype(np.float32)
    np.testing.assert_array_equal(tb._remap1(_t(x)).numpy(),
                                  np.asarray(jb._remap1(jnp.asarray(x))))
    np.testing.assert_allclose(tb.light_emit_pdf_w(_t(x)).numpy(),
                               np.asarray(jb.light_emit_pdf_w(jnp.asarray(x))),
                               rtol=1e-6)
    a = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    b = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    ng = rng.normal(size=(n, 3)).astype(np.float32)
    ng /= np.linalg.norm(ng, axis=1, keepdims=True)
    pw = rng.uniform(0.0, 3.0, n).astype(np.float32)
    got = tb._to_area(_t(pw), _t(a), _t(b), _t(ng)).numpy()
    ref = np.asarray(jb._to_area(jnp.asarray(pw), jnp.asarray(a),
                                 jnp.asarray(b), jnp.asarray(ng)))
    # rtol 1e-6 of pdf_w / d^2, the size before the cosine: XLA's rsqrt is
    # not correctly rounded and PyTorch's is, and a cosine near 0 keeps
    # that ulp of the direction as its own error
    scale = pw / ((b - a) ** 2).sum(1)
    assert (np.abs(got - ref) <= 1e-6 * (np.abs(ref) + scale)).all()
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_allclose(
        tb.cam_pdf_w(ps.camera, _t(d)).numpy(),
        np.asarray(jb.cam_pdf_w(js.camera, jnp.asarray(d))), rtol=1e-6)
    # points in front of, behind and beside the camera, and dead lanes
    pos = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(-3.0, 8.0, n)
    pos[:16] = np.inf
    pos[16:32] = np.nan
    pos[32:48, 0] = -np.inf
    jf, jon, jw, jdist, jcos = jb.project_to_screen(js.camera,
                                                    jnp.asarray(pos))
    tf, ton, tw, tdist, tcos = tb.project_to_screen(ps.camera, _t(pos))
    on = np.asarray(jon)
    np.testing.assert_array_equal(ton.numpy(), on)
    assert 0.2 < on.mean() < 0.8
    np.testing.assert_array_equal(tf.numpy()[on], np.asarray(jf)[on])
    assert (tf.numpy()[~on] == 0).all()
    for got, ref in ((tw, jw), (tdist, jdist), (tcos, jcos)):
        np.testing.assert_allclose(got.numpy()[on], np.asarray(ref)[on],
                                   rtol=1e-6)


def _mis_inputs(k, rng, scale):
    pf = [np.ones(512, np.float32)] + [
        (rng.uniform(0.0, 1.0, 512) * scale).astype(np.float32)
        for _ in range(k - 1)]
    pl = [(rng.uniform(0.0, 1.0, 512) * scale).astype(np.float32)
          for _ in range(k - 1)] + [np.ones(512, np.float32)]
    for p in pf + pl:
        p[rng.random(512) < 0.1] = 0.0  # delta pdfs
    pl[-1] = (rng.uniform(0.1, 1.0, 512) * scale).astype(np.float32)
    spec = [np.zeros(512, bool)] + [rng.random(512) < 0.15
                                    for _ in range(k - 1)]
    can = rng.random(512) < 0.9
    hit = rng.random(512) < 0.7
    return pf, pl, spec, can, hit


@pytest.mark.parametrize("three_way", [False, True])
@pytest.mark.parametrize("k,scale", [(2, 3.0), (3, 50.0), (5, 1e3),
                                     (8, 1e6)])
def test_mis_weight_matches_jax(k, scale, three_way):
    """Every strategy t of a k-vertex path; at k = 8 with pdfs up to 1e6
    the absolute products reach 1e36 and their squares overflow float32,
    so only the ratio walk stays finite."""
    rng = np.random.default_rng(k)
    pf, pl, spec, can, hit = _mis_inputs(k, rng, scale)
    n_splat = 256.0
    if k == 8:
        with np.errstate(over="ignore"):
            prod = np.prod(np.stack(pf[1:]), axis=0)
            assert not np.isfinite(prod * prod).all()
    total = np.zeros(512)
    # the strategies a pass samples: at k = 2 not t = 1, in 3-way only
    # t = 1, k - 1 and k (elsewhere the weight is never read)
    sampled = {1, k - 1, k} if three_way else set(range(1, k + 1))
    sampled -= {1} if k == 2 else set()
    for t in range(1, k + 1):
        wj = np.asarray(jb._mis_weight(
            [jnp.asarray(x) for x in pf], [jnp.asarray(x) for x in pl],
            [jnp.asarray(x) for x in spec], jnp.asarray(can), t,
            jnp.float32(n_splat), jnp.asarray(hit), three_way))
        wt = tb._mis_weight([_t(x) for x in pf], [_t(x) for x in pl],
                            [_t(x) for x in spec], _t(can), t, n_splat,
                            _t(hit), three_way).numpy()
        assert np.isfinite(wt).all() and (wt >= 0).all()
        np.testing.assert_array_equal(wt > 0, wj > 0)
        np.testing.assert_allclose(wt, wj, rtol=1e-6, atol=0)
        if t in sampled:
            total += wt
    assert total.max() <= 1.0 + 1e-5  # one denominator for every strategy


# ---------------------------------------------------------------------------
# Subpaths and strategies against the JAX package
# ---------------------------------------------------------------------------

SCENES = {
    "diffuse": lambda: _cornell(),
    "mirror": lambda: _cornell(mirror=True),
}


def jax_cache(scenes: dict):
    """get(name) -> (JAX scene, its images, its subpaths), each made once."""
    cache = {}

    def get(name):
        if name not in cache:
            js = scenes[name]()
            imgs, sub = jax_strategies(js)
            cache[name] = (js, imgs, sub)
        return cache[name]
    return get


@pytest.fixture(scope="module")
def jax_runs():
    return jax_cache(SCENES)


def _defined(a, lanes):
    a = np.asarray(a)
    return a[lanes]


def _same_vertex(vj, vt, lanes, fields, what):
    for f in fields:
        a, b = getattr(vt, f), getattr(vj, f)
        if hasattr(a, "numpy"):
            a = a.numpy()
        np.testing.assert_allclose(_defined(a, lanes), _defined(b, lanes),
                                   err_msg=f"{what} {f}", **TOL)


def same_subpaths(js, sub, traversal):
    """The port's subpaths of the pass against the JAX package's `sub`."""
    ps = to_port(js, traversal=traversal)
    feats = tb.scene_feats(ps)
    ray_o, ray_d, rand_fn, _, _ = tb._eye_wavefront(ps, [PASS], SEED)
    zs = tb.trace_camera_subpath(ps, ray_o, ray_d, rand_fn, DEPTH, feats)
    y0, ys = tb.trace_light_subpath(ps, rand_fn, DEPTH - 1, feats)
    jzs = sub["cam"]
    jy0, jys = sub["light"]
    assert len(zs) == len(jzs) == DEPTH and len(ys) == len(jys) == DEPTH - 1
    for i, (vj, vt) in enumerate(zip(jzs, zs)):
        for f in ("valid", "spec", "is_env"):
            np.testing.assert_array_equal(getattr(vt, f).numpy(),
                                          np.asarray(getattr(vj, f)),
                                          err_msg=f"z{i + 1} {f}")
        valid = np.asarray(vj.valid)
        assert valid.any()
        _same_vertex(vj, vt, valid, ("pos", "ns", "ng", "wo", "beta", "pf",
                                     "em_color"), f"z{i + 1}")
        np.testing.assert_array_equal(vt.light_row.numpy()[valid],
                                      np.asarray(vj.light_row)[valid])
        env = np.asarray(vj.is_env)
        _same_vertex(vj, vt, env, ("env_dir", "pf_w_arr", "beta"),
                     f"z{i + 1} env")
        if i + 1 < len(zs):  # pr: defined where the next vertex is
            nxt = valid & np.asarray(jzs[i + 1].valid)
            _same_vertex(vj, vt, nxt, ("pr",), f"z{i + 1}")
    for f in ("is_env", "hittable", "valid", "spec"):
        np.testing.assert_array_equal(getattr(y0, f).numpy(),
                                      np.asarray(getattr(jy0, f)),
                                      err_msg=f"y0 {f}")
    every = np.ones(y0.pos.shape[0], bool)
    _same_vertex(jy0, y0, every, ("pos", "ns", "ng", "beta", "pf",
                                  "pdf_a_far", "env_dir"), "y0")
    sky = np.asarray(jy0.is_env)
    _same_vertex(jy0, y0, sky, ("beta_dir",), "y0 sky")
    _same_vertex(jy0, y0, np.asarray(jys[0].valid), ("pr",), "y0")
    assert sky.any() == (tb.LIGHT_SKY in tb._light_types(ps))
    for j, (vj, vt) in enumerate(zip(jys, ys)):
        for f in ("valid", "spec"):
            np.testing.assert_array_equal(getattr(vt, f).numpy(),
                                          np.asarray(getattr(vj, f)),
                                          err_msg=f"y{j + 1} {f}")
        valid = np.asarray(vj.valid)
        assert valid.any()
        _same_vertex(vj, vt, valid, ("pos", "ns", "ng", "wo", "beta", "pf"),
                     f"y{j + 1}")
        if j + 1 < len(ys):
            _same_vertex(vj, vt, valid & np.asarray(jys[j + 1].valid),
                         ("pr",), f"y{j + 1}")


@pytest.mark.parametrize("traversal", ["auto", "cluster"])
def test_subpath_vertices_match_jax(jax_runs, traversal):
    js, _, sub = jax_runs("diffuse")
    same_subpaths(js, sub, traversal)


def same_strategies(js, imgs, strategy, traversal, what):
    """The port's per-strategy images of the pass against the JAX
    package's `imgs`; the full set evaluates an inner connection."""
    got = port_strategies(to_port(js, traversal=traversal), strategy)
    same_images(imgs[strategy], got, f"{what} {strategy} {traversal}")
    assert sum(float(v.sum()) for v in got.values()) > 0.0
    if strategy == "full":
        assert (2, 2) in got and float(got[(2, 2)].sum()) > 0.0


@pytest.mark.parametrize("traversal", ["auto", "cluster"])
@pytest.mark.parametrize("strategy", ["full", "3way"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_strategy_images_match_jax(jax_runs, name, strategy, traversal):
    js, imgs, _ = jax_runs(name)
    same_strategies(js, imgs, strategy, traversal, name)


def test_bdpt_pass_matches_jax_sum(jax_runs):
    """bdpt_pass: the strategies' splats summed and clamped, as the JAX
    package's bdpt_pass_impl, by the image rule."""
    js, imgs, _ = jax_runs("diffuse")
    ps = to_port(js)
    ref = np.clip(sum(imgs["full"].values()), 0.0, 1e6)
    got = tb.bdpt_pass(ps, PASS, SEED, DEPTH, device="cpu").numpy()
    assert got.shape == ref.shape
    assert _close(ref, got) >= 0.99
    np.testing.assert_allclose(got.sum(dtype=np.float64),
                               ref.sum(dtype=np.float64), rtol=1e-4)


LANE_K = np.random.default_rng(2).integers(2, 5, 256).astype(np.int32)


@pytest.fixture(scope="module")
def mmlt_runs():
    """The JAX package's images with k_only = 3 and with lane_k = LANE_K."""
    js = _cornell()
    k3, _ = jax_strategies(js, strategies=("full",), k_only=3)
    lk, _ = jax_strategies(js, lane_k=jnp.asarray(LANE_K))
    return js, k3, lk


@pytest.mark.parametrize("traversal", ["auto", "cluster"])
def test_k_only_and_lane_k_match_jax(mmlt_runs, traversal):
    """MMLT's contract: k_only = 3 (paths of exactly three vertices) and a
    per-lane depth lane_k in {2, 3, 4}."""
    js, k3, lk = mmlt_runs
    ps = to_port(js, traversal=traversal)
    got = port_strategies(ps, "full", k_only=3)
    assert sorted(got) == [(0, 3), (1, 2), (2, 1)]
    same_images(k3["full"], got, f"k_only {traversal}")
    for strat in ("full", "3way"):
        got = port_strategies(ps, strat, lane_k=torch.as_tensor(LANE_K))
        same_images(lk[strat], got, f"lane_k {strat} {traversal}")


def test_render_bdpt_is_the_mean_of_its_passes():
    """render_bdpt and render_ibpt on the device asked: the mean of their
    passes (render_ibpt = render_bdpt with the 3-way strategies), though an
    8x8 frame traces its passes in one wavefront; strategy_images alike."""
    ps = to_port(_cornell(width=8))
    img = tb.render_bdpt(ps, 2, seed=5, max_depth=3, device="cpu")
    passes = [tb.bdpt_pass(ps, i, 5, 3, device="cpu") for i in range(2)]
    assert img.device.type == "cpu" and img.shape == (8, 8, 3)
    torch.testing.assert_close(img, sum(passes) / 2, rtol=1e-6, atol=1e-7)
    ib = tb.render_ibpt(ps, 2, seed=5, max_depth=3, device="cpu")
    passes = [tb.bdpt_pass(ps, i, 5, 3, "3way", device="cpu")
              for i in range(2)]
    torch.testing.assert_close(ib, sum(passes) / 2, rtol=1e-6, atol=1e-7)
    assert not torch.equal(ib, tb.render_bdpt(ps, 2, seed=5, max_depth=3,
                                              device="cpu"))
    # several passes in one wavefront: the mean of the passes alone
    many = tb.strategy_images(ps, [0, 1], 5, 3, device="cpu")
    one = [tb.strategy_images(ps, i, 5, 3, device="cpu") for i in range(2)]
    assert sorted(many) == sorted(one[0])
    for lbl, img in many.items():
        torch.testing.assert_close(img, (one[0][lbl] + one[1][lbl]) / 2,
                                   rtol=1e-6, atol=1e-7)


def test_bdpt_entry_points_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    ps = to_port(_cornell(width=4))
    for call in (lambda: tb.render_bdpt(ps, 1),
                 lambda: tb.render_ibpt(ps, 1),
                 lambda: tb.bdpt_pass(ps, 0, 3),
                 lambda: tb.strategy_images(ps, 0, 3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
