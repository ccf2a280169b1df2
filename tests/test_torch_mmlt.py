"""MMLT in the port (integrators/mmlt.py) and the oracle's _SeqU /
OracleMMLT (integrators/oracle.py) against the JAX package's on the same
inputs, and against the port's own oracle.

The JAX side runs eagerly (jax.disable_jit()), as in
tests/test_torch_bdpt.py: under jit XLA:CPU contracts the dense triangle
test into FMAs and moves equal-t ties on the box's edges. Every JAX run of
the file evaluates 1,024 lanes of one 16x16 box, so its eager compiles are
paid once.

Tolerances:
  * psv_dims and _init_psv bit for bit; _alloc_from_b0 equal;
  * _resample_states on inputs whose float32 prefix sums are exact (small
    integers): the picks equal (these integer and prefix-sum functions
    run under jit: XLA contracts no multiply-add there);
  * _eval_merged of one merged step's proposals (vectors with a per-lane
    depth group in {2, 3, 4}), as the JAX package's step evaluates them:
    lane by lane, colours (every strategy) and f within 1e-3
    on >= 99% of lanes (the image rule of tests/test_torch_pt.py), pixels
    equal on every lane a strategy reaches with a non-zero colour;
  * _mmlt_step_merged from one shared chain state (the port's
    _eval_merged of the vectors the proposals mutate): each group's splat
    image by the image rule, the accept decisions equal on >= 99.9% of
    chains, b_cnt exact, b_acc within rtol 1e-4, group by group;
  * OracleMMLT.eval_state and .render against the JAX package's at rtol
    1e-9 (the same float64 walk and default_rng stream);
  * _SeqU raises IndexError when its vector runs out;
  * tests/test_mmlt.py's allocation check at its own size: on the bulb in
    a glass shell the groups of k >= 4 get more than 20% of the chains.

Statistical checks: tests/test_oracle_mmlt.py's strategy-sum check at
k = 2 runs here, at its own size, chain count and limits, on the port's
OracleMMLT and OracleSBDPT. The others (test_oracle_mmlt.py at k = 3 and
its check of render_mmlt, and test_mmlt.py's checks of render_mmlt
against PT, SBDPT and the mirror caustic) take minutes of the CPU at their
own sizes: chip_smoke.py's phase 19 (metropolis_statistics) runs them
unchanged, with the port's PT, SBDPT and OracleMMLT as references (the
bulb in a glass shell on the card, the others on the CPU twins in worker
processes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore_tpu.integrators import mmlt as jmm
from hydracore_tpu.integrators import oracle as jor
from hydracore_tpu.scene.procedural import SceneBuilder
from hydracore_tpu_torch.integrators import mmlt as tmm
from hydracore_tpu_torch.integrators import oracle as tor
from tests.test_mmlt import _sds_caustic_scene
from tests.test_torch_scene import to_port

torch.set_num_threads(1)

SEED = 777
R = 1024  # lanes of every JAX run of the file (one set of eager compiles)
KMAX = 4  # the box's depth 3: groups k = 2..4
STEP = 21


def _cornell(width: int = 16):
    """tests/test_mmlt.py's diffuse box, depth 3."""
    b = SceneBuilder()
    m = b.lambert([0.6, 0.6, 0.6])
    red = b.lambert([0.7, 0.15, 0.1])
    b.add_box_interior(2.0, m, m, m, red, m)
    b.rect_light([0, 1.95, 0], 0.6, 0.6, [10.0, 10.0, 10.0])
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=width,
                   height=width, trace_depth=3)


def _close(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b).reshape(a.shape[0], -1).max(-1)
                  <= 1e-3).mean())


def test_psv_dims_and_init_psv_match_jax():
    for k in range(2, 8):
        assert tmm.psv_dims(k) == jmm.psv_dims(k)
    for Rk, k, salt in ((R, 0, 0), (257, 5, 0x9E3779B9 * 3 & 0xFFFFFFFF),
                        (64, 3, 0xFFFFFFF0)):
        D = jmm.psv_dims(KMAX)
        ref = np.asarray(jax.jit(jmm._init_psv, static_argnums=(0, 1, 2, 3, 4))(
            Rk, D, k, SEED, salt))
        got = tmm._init_psv(Rk, D, k, SEED, salt=salt).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("b0", [
    {2: 3.0, 3: 1.0, 4: 0.5}, {2: 0.0, 3: 1e-9, 4: 7.0},
    {2: 0.0, 3: 0.0}, {4: 2.5, 5: 2.5, 6: 2.5}, {2: -1.0, 3: 2.0}])
def test_alloc_from_b0_matches_jax(b0):
    for n in (1000, 2304, 1 << 20):
        assert tmm._alloc_from_b0(b0, n) == jmm._alloc_from_b0(b0, n)


def test_resample_states_match_jax():
    """Exact float32 prefix sums (small integers, zeros among them): the
    picks are the JAX package's."""
    g = np.random.default_rng(4)
    n = 4096
    u = g.random((n, 8), np.float32)
    f = g.integers(0, 6, n).astype(np.float32)
    for Rk, k in ((256, 2), (1024, 5), (3000, 3)):
        seed = (SEED ^ 0xA511E9B3) & 0xFFFFFFFF
        ju, jf = jmm._resample_states(jnp.asarray(u), jnp.asarray(f), Rk, k,
                                      jnp.uint32(seed))
        tu, tf = tmm._resample_states(torch.as_tensor(u), torch.as_tensor(f),
                                      Rk, k, seed)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert float(tf.min()) > 0.0


@pytest.fixture(scope="module")
def jax_merged():
    """One merged step of the JAX package on the box, eager, from a shared
    chain state (the port's _eval_merged of R vectors with depth groups in
    {2, 3, 4}), with the proposals and the JAX package's _eval_merged of
    them kept as the step made them."""
    js = _cornell()
    g = np.random.default_rng(6)
    psv = g.random((R, jmm.psv_dims(KMAX)), np.float32)
    lane_k = g.integers(2, KMAX + 1, R).astype(np.int32)
    gid = (lane_k - 2).astype(np.int32)
    hw = js.camera.width * js.camera.height
    state = [x.numpy() for x in tmm._eval_merged(
        to_port(js), torch.as_tensor(psv), torch.as_tensor(lane_k), KMAX, 3)]
    kept = {}
    saved = jmm._eval_merged

    def keep(scene, u, *a):
        out = saved(scene, u, *a)
        kept["u"], kept["eval"] = np.asarray(u), [np.asarray(x) for x in out]
        return out

    jmm._eval_merged = keep
    try:
        with jax.disable_jit():
            step = jmm._mmlt_step_merged(
                js, jnp.zeros((3 * hw, 3), jnp.float32), jnp.asarray(psv),
                jnp.asarray(state[2]), jnp.asarray(state[0].astype(np.int32)),
                jnp.asarray(state[1]), jnp.asarray(lane_k), jnp.asarray(gid),
                jnp.uint32(STEP), jnp.uint32(SEED), 3, KMAX, 3, 1024.0, 1.0,
                hw)
    finally:
        jmm._eval_merged = saved
    return dict(js=js, psv=psv, lane_k=lane_k, gid=gid, hw=hw, state=state,
                prop=kept["u"], eval=kept["eval"],
                step=tuple(np.asarray(x) for x in step))


def _same_pixels(ref_pix, ref_col, pix, col):
    """Pixels equal wherever both colours of a strategy are non-zero (an
    off-screen t = 1 splat carries no colour and no defined pixel)."""
    on = (np.abs(ref_col).max(-1) > 0) & (np.abs(col).max(-1) > 0)
    assert on.any()
    np.testing.assert_array_equal(pix[on], ref_pix[on])


@pytest.mark.parametrize("traversal", ["auto", "cluster"])
def test_eval_merged_matches_jax(jax_merged, traversal):
    r = jax_merged
    ps = to_port(r["js"], traversal=traversal)
    pix, col, f = tmm._eval_merged(ps, torch.tensor(r["prop"]),
                                   torch.as_tensor(r["lane_k"]), KMAX, 3)
    jpix, jcol, jf = r["eval"]
    assert pix.shape == jpix.shape and col.shape == jcol.shape
    pix, col, f = pix.numpy(), col.numpy(), f.numpy()
    _same_pixels(jpix, jcol, pix, col)
    assert _close(jcol, col) >= 0.99
    assert _close(jf[:, None], f[:, None]) >= 0.99
    for k in range(2, KMAX + 1):  # every group carries light
        assert f[r["lane_k"] == k].sum() > 0.0, k


def test_mmlt_step_merged_matches_jax(jax_merged):
    r = jax_merged
    ps = to_port(r["js"])
    hw = r["hw"]
    pix0, col0, f0 = (torch.as_tensor(x) for x in r["state"])
    out = tmm._mmlt_step_merged(
        ps, torch.zeros((3 * hw, 3)), torch.as_tensor(r["psv"]), f0, pix0,
        col0, torch.as_tensor(r["lane_k"]),
        torch.as_tensor(r["gid"]), STEP, SEED, 3, KMAX, 3, 1024.0, 1.0, hw)
    fb, u, f, pix, col, ba, bc = (x.numpy() for x in out)
    jfb, ju, jf1, jpix1, jcol1, jba, jbc = r["step"]
    for gi in range(3):  # each group's slab by the image rule
        sl = slice(gi * hw, (gi + 1) * hw)
        assert jfb[sl].sum() > 0.0
        assert _close(jfb[sl], fb[sl]) >= 0.99, gi
    j_acc = (ju != r["psv"]).any(1)
    t_acc = (u != r["psv"]).any(1)
    assert 0.05 < j_acc.mean() < 0.95
    assert (j_acc == t_acc).mean() >= 0.999, (j_acc != t_acc).sum()
    np.testing.assert_array_equal(bc, jbc)
    np.testing.assert_allclose(ba, jba, rtol=1e-4)
    both = j_acc == t_acc
    _same_pixels(jpix1[both], jcol1[both], pix[both], col[both])


def test_probe_depth_alloc_follows_contribution():
    """tests/test_mmlt.py's allocation check on the port: the deep groups
    that carry the bulb's SDS transport get chains."""
    ps = to_port(_sds_caustic_scene())
    alloc = tmm.probe_depth_alloc(ps, n_chains=24 * 24 * 4, seed=5,
                                  max_depth=6, device="cpu")
    ks = sorted(alloc)
    assert ks[0] >= 2
    total = sum(alloc.values())
    assert total > 0
    deep = sum(v for k, v in alloc.items() if k >= 4)
    assert deep > 0.2 * total, alloc


@pytest.fixture(scope="module")
def oracles():
    """The oracle tests' 12x12 box in both packages' OracleMMLT."""
    b = SceneBuilder()
    m = b.lambert([0.6, 0.6, 0.6])
    red = b.lambert([0.7, 0.15, 0.1])
    b.add_box_interior(2.0, m, m, m, red, m)
    b.rect_light([0, 1.95, 0], 0.6, 0.6, [10.0, 10.0, 10.0])
    js = b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=12,
                 height=12, trace_depth=3)
    ps = to_port(js)
    return jor.OracleMMLT(js), tor.OracleMMLT(ps), ps


@pytest.mark.parametrize("k", [2, 3, 4])
def test_oracle_eval_state_matches_jax(oracles, k):
    jo, to, _ = oracles
    g = np.random.default_rng(k)
    live = 0
    for _ in range({2: 400, 3: 80, 4: 40}[k]):  # k = 2: the light seen
        u = g.random(to.dims(k))
        jf, js_ = jo.eval_state(u, k)
        tf, ts_ = to.eval_state(u, k)
        assert tf == pytest.approx(jf, rel=1e-9, abs=1e-300)
        assert [(y, x) for y, x, _ in ts_] == [(y, x) for y, x, _ in js_]
        for (_, _, a), (_, _, b) in zip(js_, ts_):
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-300)
        live += tf > 0.0
    assert live > 0


def test_oracle_render_matches_jax(oracles):
    jo, to, _ = oracles
    kw = dict(n_chains=4, n_steps=6, n_pool=24, seed=5)
    ref = jo.render([2, 3], **kw)
    got = to.render([2, 3], **kw)
    assert got.sum() > 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-300)


def test_seq_u_raises_when_exhausted():
    s = tor._SeqU([0.25, 0.5, 0.75])
    assert s.random() == 0.25
    np.testing.assert_array_equal(s.random(2), [0.5, 0.75])
    with pytest.raises(IndexError, match="exhausted"):
        s.random()
    with pytest.raises(IndexError, match="want 2, have 1"):
        tor._SeqU([0.1]).random(2)


def _block(a, n=3):
    w = a.shape[0] // n
    return a.reshape(n, w, n, w, 3).mean(axis=(1, 3))


def test_oracle_mmlt_matches_strategy_sum(oracles):
    """tests/test_oracle_mmlt.py's strategy-sum check at k = 2 on the
    port's oracles (the (1, 1) splat is excluded, oracle._weight)."""
    _, omm, _ = oracles
    ref = omm.o.render_strategy(0, 2, spp=24, seed=29 + 0 + 7 * 2)
    got = omm.render([2], n_chains=24, n_steps=220, n_pool=400, seed=5)
    tot = abs(got.mean() - ref.mean()) / max(ref.mean(), 1e-12)
    assert tot < 0.20, (ref.mean(), got.mean())
    rb, gb = _block(np.asarray(ref)), _block(got)
    mask = rb.mean(-1) > 0.05 * max(ref.mean(), 1e-9)
    rel = np.abs(rb - gb).mean(-1)[mask] / np.maximum(rb.mean(-1)[mask],
                                                      1e-9)
    assert np.median(rel) < 0.30, np.median(rel)


def test_mmlt_entry_points_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    ps = to_port(_cornell(4))
    for call in (lambda: tmm.render_mmlt(ps, 1, mutations_per_pass=1),
                 lambda: tmm.probe_depth_alloc(ps, 256)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
