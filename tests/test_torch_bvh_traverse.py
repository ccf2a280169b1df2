"""The port's binary-BVH traversal (ops/traverse.py) against the JAX
package's on the same tree and rays, and against the brute-force oracle
tests/test_bvh_traverse.py uses.

Tolerances: equal hit masks; t within rtol 1e-4 / atol 1e-5 of the numpy
Moller-Trumbore over all triangles (that test's own); against the JAX
traversal the same triangle on every ray, t within rtol 1e-4 and u, v
within rtol 1e-3 / atol 1e-4 (both walk the same nodes in the same order;
XLA contracts multiply-adds that eager PyTorch keeps apart, which a small
determinant amplifies in u and v). The traversal is also run on a scene's
own bvh_* leaves against the dense route.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore_tpu.bvh.builder import brute_force_closest_hit
from hydracore_tpu.bvh.builder import build_bvh as jax_build_bvh
from hydracore_tpu.ops import traverse as jtr
from hydracore_tpu_torch.bvh.builder import build_bvh
from hydracore_tpu_torch.ops import traverse as ptr
from hydracore_tpu_torch.ops import traverse_dense as ptd
from hydracore_tpu_torch.scene.procedural import SceneBuilder as PortBuilder
from tests.test_torch_scene import build_with, rects_recipe

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)


def random_tri_soup(n, rng):
    c = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    a = c + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    b = c + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = c + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    return a, b, d


class _FakeScene:
    """The arrays ops/traverse.py reads, as `to` makes them (jnp.asarray
    for the JAX package, torch.tensor for the port)."""

    def __init__(self, build, to, v0, v1, v2):
        bvh = build(v0, v1, v2)
        p = bvh.perm
        self.tri_v0 = to(v0[p])
        self.tri_e1 = to((v1 - v0)[p])
        self.tri_e2 = to((v2 - v0)[p])
        self.bvh_bmin = to(bvh.bmin)
        self.bvh_bmax = to(bvh.bmax)
        self.bvh_left = to(bvh.left)
        self.bvh_right = to(bvh.right)
        self.bvh_count = to(bvh.count)


def _rays(rng, R):
    ro = rng.uniform(-8, 8, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


@pytest.mark.parametrize("n_tris", [1, 7, 100, 1500])
def test_closest_hit_matches_bruteforce_and_jax(n_tris):
    rng = np.random.default_rng(42 + n_tris)
    v0, v1, v2 = random_tri_soup(n_tris, rng)
    ps = _FakeScene(build_bvh, torch.tensor, v0, v1, v2)
    js = _FakeScene(jax_build_bvh, jnp.asarray, v0, v1, v2)
    ro, rd = _rays(rng, 256)

    t, tri, u, v = (x.numpy() for x in ptr.closest_hit(
        ps, torch.tensor(ro), torch.tensor(rd)))
    t_ref, _, _, _ = brute_force_closest_hit(
        ro, rd, ps.tri_v0.numpy(), ps.tri_e1.numpy(), ps.tri_e2.numpy())
    hit = np.isfinite(t)
    assert (hit == np.isfinite(t_ref)).all()
    assert np.allclose(t[hit], t_ref[hit], rtol=1e-4, atol=1e-5)
    assert (tri[~hit] == -1).all()

    t_j, tri_j, u_j, v_j = (np.asarray(x) for x in jtr.closest_hit(
        js, jnp.asarray(ro), jnp.asarray(rd)))
    assert np.array_equal(tri, tri_j)
    np.testing.assert_allclose(t[hit], t_j[hit], rtol=1e-4)
    for a, b in ((u, u_j), (v, v_j)):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-3, atol=1e-4)


def test_any_hit_consistent_with_closest():
    rng = np.random.default_rng(7)
    v0, v1, v2 = random_tri_soup(300, rng)
    ps = _FakeScene(build_bvh, torch.tensor, v0, v1, v2)
    js = _FakeScene(jax_build_bvh, jnp.asarray, v0, v1, v2)
    ro, rd = _rays(rng, 128)
    to, td = torch.tensor(ro), torch.tensor(rd)

    t = ptr.closest_hit(ps, to, td)[0].numpy()
    occ = ptr.any_hit(ps, to, td, t_max=1e30).numpy()
    assert (occ == np.isfinite(t)).all() and 5 < occ.sum() < occ.size
    # with t_max below the closest hit, must be unoccluded
    short = np.where(np.isfinite(t), t * 0.5, 1e-3).astype(np.float32)
    assert not ptr.any_hit(ps, to, td, t_max=torch.tensor(short)).any()
    # inactive rays never hit
    act = np.arange(128) % 2 == 0
    t_a, tri_a, _, _ = ptr.closest_hit(ps, to, td, active=torch.tensor(act))
    assert not torch.isfinite(t_a[~act]).any() and (tri_a[~act] == -1).all()
    assert np.array_equal(t_a.numpy()[act], t[act])
    occ_j = np.asarray(jtr.any_hit(js, jnp.asarray(ro), jnp.asarray(rd),
                                   t_max=jnp.asarray(short * 3.0)))
    occ_p = ptr.any_hit(ps, to, td, t_max=torch.tensor(short * 3.0)).numpy()
    assert np.array_equal(occ_p, occ_j)


def test_traverse_reads_a_scene_s_own_tree():
    """On a built scene's bvh_* leaves the binary walk finds the dense
    route's hits: equal masks, the same triangle on > 99.9% of hits, t
    within rtol 1e-4."""
    ps = build_with(PortBuilder, rects_recipe)
    ro, rd = (torch.tensor(x) for x in _rays(np.random.default_rng(3), 1024))
    ro = ro * 0.75
    t_b, tri_b, _, _ = ptr.closest_hit(ps, ro, rd)
    t_d, tri_d, _, _ = ptd.closest_hit(ps, ro, rd)
    h = torch.isfinite(t_d)
    assert torch.equal(torch.isfinite(t_b), h) and 50 < int(h.sum()) < 1024
    assert float((tri_b[h] == tri_d[h]).float().mean()) > 0.999
    np.testing.assert_allclose(t_b[h].numpy(), t_d[h].numpy(), rtol=1e-4)
    assert torch.equal(ptr.any_hit(ps, ro, rd, 6.0), ptd.any_hit(ps, ro, rd, 6.0))
