"""PSSMLT in the port (integrators/mlt.py, and the legacy mode of
integrators/pt.py:pt_trace it runs) against the JAX package's on the same
inputs, and against the port's own PT.

The JAX side runs eagerly (jax.disable_jit()): under jit XLA:CPU contracts
the dense triangle test into FMAs and moves equal-t ties on the box's
edges (tests/test_torch_gbuffer.py). One frame size and one chain count per
scene keep its eager compiles to one set.

Tolerances:
  * pt_trace(rand_fn=..., has_alpha=False) against pt_trace_impl with the
    same numpy-made uniforms, on 1,024 lanes: per lane, >= 99% of lanes
    within 1e-3 (the image rule of tests/test_torch_pt.py, lane by lane),
    the rays traced within 1%; on the port's auto and cluster routes, on
    tests/test_mlt.py's diffuse box and on tests/textured_scenes.py's
    alpha recipe (whose opacity maps pass camera-path rays but are opaque
    to the shadow rays, as in the JAX package);
  * _trace_from_psv on 1,024 numpy-made vectors, on the box by both
    routes: colours by the image rule lane by lane, the pixels equal;
  * the legacy mode with the hash streams of a pass equals the
    persistent-sorted mode bit for bit (the same sample set);
  * _mutate: `large` equal, the proposal within atol 1e-6 on the circle
    (mod 1; the small step goes through a float32 exp), the large steps
    bit for bit;
  * mlt_step from one shared chain state: the splat image by the image
    rule, the accept decisions equal on >= 99.9% of chains, b_cnt exact,
    b_acc within rtol 1e-4;
  * render_mlt at 16x16 with 1,024 chains (2 passes of 1 mutation, the
    first a burn-in pass): by the image rule against the JAX package's render (no
    accept decision flips at this size; the step test carries the parity
    of one mutation);
  * the statistical check of tests/test_mlt.py (render_mlt against PT at
    16x16: means within 15%, median 4x4-block error below 15%) at its own
    size, chain count and seeds, against the port's PT.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.textured_scenes as ts
from hydracore_tpu.integrators import mlt as jm
from hydracore_tpu.integrators import pt as jpt
from hydracore_tpu.scene.procedural import SceneBuilder
from hydracore_tpu_torch.integrators import mlt as tm
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.ops import rng as trng
from tests.test_torch_scene import to_port

torch.set_num_threads(1)

SEED = 777
R = 1024  # lanes of every JAX run of the file (one set of eager compiles)


def _cornell(width: int = 16):
    """tests/test_mlt.py's diffuse box, depth 3."""
    b = SceneBuilder()
    m = b.lambert([0.6, 0.6, 0.6])
    red = b.lambert([0.7, 0.15, 0.1])
    b.add_box_interior(2.0, m, m, m, red, m)
    b.rect_light([0, 1.95, 0], 0.6, 0.6, [10.0, 10.0, 10.0])
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=width,
                   height=width, trace_depth=3)


SCENES = {"cornell": _cornell, "alpha": ts.alpha}


def _close(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b).reshape(a.shape[0], -1).max(-1)
                  <= 1e-3).mean())


def _psv(n, D, seed):
    return np.random.default_rng(seed).random((n, D), np.float32)


def _uniforms(max_depth, seed):
    """Numpy-made (R, 4) uniforms for every (depth, group) pt_trace reads."""
    g = np.random.default_rng(seed)
    return {(d, grp): g.random((R, 4), np.float32)
            for d in range(max_depth) for grp in range(7)}


@pytest.fixture(scope="module")
def jax_runs():
    """Per scene: the JAX package's legacy pt_trace_impl on numpy-made
    uniforms and its _trace_from_psv on numpy-made vectors, eager, once."""
    cache = {}

    def run(name):
        if name not in cache:
            js = SCENES[name]()
            md = js.settings.trace_depth
            W, H = js.camera.width, js.camera.height
            psv = _psv(R, jm.psv_dims(md), 5)
            uni = _uniforms(md, 9)
            with jax.disable_jit():
                px = jnp.asarray((psv[:, 0] * W).astype(np.int32))
                py = jnp.asarray((psv[:, 1] * H).astype(np.int32))
                ray_o, ray_d = jpt.make_eye_rays(
                    js.camera, px, py, jnp.asarray(psv[:, 4:6]),
                    jnp.asarray(psv[:, 2:4]))
                col, rays = jpt.pt_trace_impl(
                    js, ray_o, ray_d, lambda d, g: jnp.asarray(uni[d, g]),
                    max_depth=md, has_alpha=False)
                c_psv, p_psv = (jm._trace_from_psv(js, jnp.asarray(psv), md)
                                if name == "cornell" else (None, None))
            cache[name] = dict(
                js=js, psv=psv, uni=uni, md=md,
                rays=(np.asarray(ray_o), np.asarray(ray_d)),
                legacy=(np.asarray(col), float(rays)),
                from_psv=(np.asarray(c_psv), np.asarray(p_psv)))
        return cache[name]
    return run


@pytest.mark.parametrize("traversal", ["auto", "cluster"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_legacy_pt_trace_matches_jax(jax_runs, name, traversal):
    r = jax_runs(name)
    ps = to_port(r["js"], traversal=traversal)
    uni = {k: torch.as_tensor(v) for k, v in r["uni"].items()}
    o, d = (torch.tensor(x) for x in r["rays"])
    col, rays = tpt.pt_trace(ps, o, d, None, None, r["md"],
                             rand_fn=lambda dd, g: uni[dd, g],
                             has_alpha=False)
    ref, ref_rays = r["legacy"]
    assert np.isfinite(col.numpy()).all() and float(col.sum()) > 0.0
    close = _close(ref, col.numpy())
    assert close >= 0.99, close
    assert abs(int(rays) - ref_rays) <= 0.01 * ref_rays, (int(rays), ref_rays)


@pytest.mark.parametrize("traversal", ["auto", "cluster"])
def test_trace_from_psv_matches_jax(jax_runs, traversal):
    r = jax_runs("cornell")
    ps = to_port(r["js"], traversal=traversal)
    col, pix = tm._trace_from_psv(ps, torch.as_tensor(r["psv"]), r["md"])
    ref_c, ref_p = r["from_psv"]
    np.testing.assert_array_equal(pix.numpy(), ref_p)
    assert float(col.min()) >= 0.0 and float(col.sum()) > 0.0
    close = _close(ref_c, col.numpy())
    assert close >= 0.99, close


def test_legacy_mode_with_hash_streams_is_the_pass():
    """The legacy mode fed a pass's hash streams traces the pass's sample
    set: equal, lane by lane, to the persistent-sorted mode on the cluster
    route (which permutes the wavefront every bounce)."""
    ps = to_port(_cornell(), traversal="cluster")
    o, d, sidx, _ = tpt.primary_rays(ps, [0, 1], SEED)
    ref, ref_rays = tpt.pt_trace(ps, o, d, sidx, SEED, 3)
    got, rays = tpt.pt_trace(ps, o, d, None, None, 3, rand_fn=lambda dd, g:
                             trng.rand4(sidx, dd, g, SEED))
    assert torch.equal(got, ref) and int(rays) == int(ref_rays)


@pytest.mark.parametrize("step_size", [1.0, 2.0])
@pytest.mark.parametrize("step_power", [512.0, 1024.0, 2048.0])
def test_mutate_matches_jax(step_power, step_size):
    D = jm.psv_dims(5)
    u = _psv(R, D, 3)
    for salt in (0, 0x9E3779B9):  # MLT's chain keys and MMLT's
        key = (np.arange(R, dtype=np.uint64) + salt) & 0xFFFFFFFF
        with jax.disable_jit():
            ju, jl = jm._mutate(jnp.asarray(u), jnp.asarray(key, jnp.uint32),
                                jnp.uint32(4000000123), jnp.uint32(SEED),
                                step_power=step_power, step_size=step_size)
        tu, tl = tm._mutate(torch.as_tensor(u),
                            torch.as_tensor(key.astype(np.int64)), 4000000123,
                            SEED, step_power=step_power, step_size=step_size)
        jl, ju = np.asarray(jl), np.asarray(ju)
        np.testing.assert_array_equal(tl.numpy(), jl)
        assert 0.2 < jl.mean() < 0.4
        np.testing.assert_array_equal(tu.numpy()[jl], ju[jl])
        diff = np.abs(tu.numpy() - ju)
        circ = np.minimum(diff, 1.0 - diff)
        assert circ.max() <= 1e-6, circ.max()
        assert float(tu.min()) >= 0.0 and float(tu.max()) <= 1.0


def _state(js, seed):
    """A shared chain state: vectors, positive luminances and colours,
    pixels."""
    g = np.random.default_rng(seed)
    W, H = js.camera.width, js.camera.height
    u = g.random((R, jm.psv_dims(js.settings.trace_depth)), np.float32)
    c = g.uniform(0.01, 2.0, (R, 3)).astype(np.float32)
    f = (0.2126 * c[:, 0] + 0.7152 * c[:, 1] + 0.0722 * c[:, 2]).astype(
        np.float32)
    pix = g.integers(0, W * H, R).astype(np.int32)
    return u, f, c, pix


def test_mlt_step_matches_jax():
    js = _cornell()
    ps = to_port(js)
    W, H = js.camera.width, js.camera.height
    u, f, c, pix = _state(js, 11)
    step = 37
    with jax.disable_jit():
        jout = jm.mlt_step(js, jnp.zeros((W * H, 3), jnp.float32),
                           jnp.asarray(u), jnp.asarray(f), jnp.asarray(c),
                           jnp.asarray(pix), jnp.uint32(step),
                           jnp.uint32(SEED), 3)
    jfb, ju, jf, jc, jpix, jba, jbc = (np.asarray(x) for x in jout)
    tout = tm.mlt_step(ps, torch.zeros((W * H, 3)), torch.as_tensor(u),
                       torch.as_tensor(f), torch.as_tensor(c),
                       torch.as_tensor(pix.astype(np.int64)), step, SEED, 3)
    tfb, tu, tf, tc, tpix, tba, tbc = (x.numpy() for x in tout)
    assert _close(jfb, tfb) >= 0.99
    j_acc = (ju != u).any(1)
    t_acc = (tu != u).any(1)
    assert 0.05 < j_acc.mean() < 0.95
    assert (j_acc == t_acc).mean() >= 0.999, (j_acc != t_acc).sum()
    both = j_acc == t_acc
    np.testing.assert_array_equal(tpix[both], jpix[both])
    assert float(tbc) == float(jbc)
    np.testing.assert_allclose(float(tba), float(jba), rtol=1e-4)


def test_render_mlt_matches_jax():
    js = _cornell()
    kw = dict(n_passes=2, n_chains=R, mutations_per_pass=1, seed=5,
              burn_in=1)
    with jax.disable_jit():
        ref = np.asarray(jm.render_mlt(js, **kw))
    got = tm.render_mlt(to_port(js), device="cpu", **kw)
    assert got.shape == (16, 16, 3) and got.dtype == torch.float32
    assert float(got.sum()) > 0.0
    assert _close(ref.reshape(-1, 3), got.numpy().reshape(-1, 3)) >= 0.99


def test_mlt_matches_pt():
    """tests/test_mlt.py's check on the port: render_mlt against the port's
    PT on the diffuse box."""
    sc = to_port(_cornell())
    pt = tpt.render(sc, spp=128, seed=3, device="cpu").numpy()
    mlt = tm.render_mlt(sc, n_passes=30, n_chains=16 * 16 * 6,
                        mutations_per_pass=8, seed=7, burn_in=6,
                        device="cpu").numpy()
    rel = abs(pt.mean() - mlt.mean()) / max(pt.mean(), 1e-9)
    assert rel < 0.15, (pt.mean(), mlt.mean())
    a = pt.reshape(4, 4, 4, 4, 3).mean(axis=(1, 3))
    c = mlt.reshape(4, 4, 4, 4, 3).mean(axis=(1, 3))
    mask = a.mean(-1) > 0.05
    relmap = np.abs(a - c).mean(-1)[mask] / np.maximum(a.mean(-1)[mask], 1e-9)
    assert np.median(relmap) < 0.15, np.median(relmap)


def test_mlt_entry_point_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.render_mlt(to_port(_cornell(4)), 1, mutations_per_pass=1)
