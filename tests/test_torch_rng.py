"""Bit-exactness of the port's integer streams against the JAX package:
the counter-based RNG, the Morton pixel order and the ray sort key.
Every comparison is bitwise (tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore_tpu.integrators import pt as jpt
from hydracore_tpu.ops import rng as jrng
from hydracore_tpu.ops import trace_api as jtrace
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.ops import rng as trng
from hydracore_tpu_torch.ops import trace_api as ttrace

N = 100_000


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a.astype(np.uint32)


def _same(a, b):
    a = _bits(a)
    b = b.numpy()
    b = b.view(np.uint32) if b.dtype == np.float32 else b.astype(np.uint32)
    assert a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def idx():
    rng = np.random.default_rng(20260)
    u = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    u[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]  # edge words
    return u


def test_pcg3d(idx):
    v = np.stack([idx, idx[::-1], idx ^ np.uint32(0x5BD1E995)], -1)
    _same(jrng.pcg3d(jnp.asarray(v)), trng.pcg3d(trng.u32(v)))


def test_hash_u32(idx):
    _same(jrng.hash_u32(jnp.asarray(idx)), trng.hash_u32(trng.u32(idx)))


@pytest.mark.parametrize("bounce,group,seed", [(0, 0, 777), (3, 2, 777),
                                               (4, 1, 0xDEADBEEF)])
def test_rand4_rand2(idx, bounce, group, seed):
    _same(jrng.rand4(jnp.asarray(idx), bounce, group, seed),
          trng.rand4(trng.u32(idx), bounce, group, seed))
    _same(jrng.rand2(jnp.asarray(idx), bounce, group, seed),
          trng.rand2(trng.u32(idx), bounce, group, seed))


@pytest.mark.parametrize("dim", [0, 1, 5])
def test_sobol(idx, dim):
    _same(jrng.sobol(jnp.asarray(idx), dim, 0x1234567),
          trng.sobol(trng.u32(idx), dim, 0x1234567))


def test_screen_sample(idx):
    passes = (idx % 4096).astype(np.uint32)
    _same(jrng.screen_sample(jnp.asarray(passes), jnp.asarray(idx)),
          trng.screen_sample(trng.u32(passes), trng.u32(idx)))


@pytest.mark.parametrize("wh", [(64, 64), (40, 24), (1024, 1024)])
def test_morton_pixel_order(wh):
    W, H = wh
    assert np.array_equal(jpt._morton_pixel_order(W, H),
                          tpt._morton_pixel_order(W, H))
    assert np.array_equal(jpt._morton_pixel_inverse(W, H),
                          tpt._morton_pixel_inverse(W, H))


def test_ray_sort_key():
    rng = np.random.default_rng(5)
    o = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[:8] = 0.0  # exact zero components: octant bit 0
    bmin = np.array([-2.5, -2.0, -1.5], np.float32)
    bext = np.array([5.0, 4.0, 3.0], np.float32)

    class S:  # the two fields ray_sort_key reads
        pass

    js, ts = S(), S()
    js.world_bmin, js.world_bext = bmin, bext
    ts.world_bmin, ts.world_bext = torch.tensor(bmin), torch.tensor(bext)
    _same(jtrace.ray_sort_key(js, jnp.asarray(o), jnp.asarray(d)),
          ttrace.ray_sort_key(ts, torch.tensor(o), torch.tensor(d)))
