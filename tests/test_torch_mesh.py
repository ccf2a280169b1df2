"""parallel/mesh.py on torch.distributed: two gloo ranks in spawned
processes (a FileStore under tmp_path) against the port's single-device
integrators on the CPU, the world of 1 that make_mesh makes in-process
(or through torchrun's env:// variables), and that world of 1 against the
JAX package's render_distributed on a 1-device mesh.

Tolerances: pixel sharding traces the very rays render_pass traces (every
ray's numbers depend only on its pixel and pass), so rtol 1e-6; sample
sharding sums n pass images in another order than the sequential mean,
so rtol 1e-5 (tests/test_multichip.py's rule); LT sharding runs the very
lt_pass calls, all_reduce adding them in rank order, rtol 1e-6; against
the JAX package, the image rule of tests/test_torch_pt.py (>= 99% of pixels
within 1e-3).
"""
import multiprocessing as mp
import socket

import numpy as np
import pytest
import torch

from hydracore_tpu_torch.integrators.lt import lt_pass
from hydracore_tpu_torch.integrators.pt import render_pass
from hydracore_tpu_torch.parallel import mesh as pm
from hydracore_tpu_torch.scene.procedural import SceneBuilder

torch.set_num_threads(1)

SEED = 7
DEPTH = 3
N_PATHS = 96


def _scene(builder=SceneBuilder):
    b = builder()
    m = b.lambert([0.7, 0.3, 0.3])
    w = b.lambert([0.6, 0.6, 0.6])
    b.add_box_interior(2.0, m, w, w, w, w)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [15.0, 15.0, 15.0])
    return b.build(cam_pos=[0, 0, 5.5], cam_lookat=[0, 0, 0], width=8,
                   height=8, trace_depth=DEPTH)


def _rank_main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = pm.make_mesh("cpu")
        assert (mesh.rank, mesh.size, mesh.owned) == (rank, world, False)
        sc = pm.place(_scene(), mesh)
        pix, pix_rays = pm.render_pass_pixel_sharded(sc, 3, SEED, mesh, DEPTH)
        smp, smp_rays = pm.render_pass_sample_sharded(sc, 1, SEED, mesh, DEPTH)
        lt, paths = pm.render_lt_pass_sharded(sc, 1, SEED, mesh, N_PATHS, DEPTH)
        dist5 = pm.render_distributed(sc, 5, mesh=mesh, seed=SEED,
                                      max_depth=DEPTH)
        px2 = pm.render_distributed(sc, 2, mesh=mesh, seed=SEED,
                                    max_depth=DEPTH, mode="pixel")
        lt5 = pm.render_lt_distributed(sc, 5, mesh=mesh, seed=SEED,
                                       paths_per_pass=N_PATHS, max_depth=DEPTH)
        np.savez(f"{out}/r{rank}.npz", pix=pix.numpy(), pix_rays=int(pix_rays),
                 smp=smp.numpy(), smp_rays=int(smp_rays), lt=lt.numpy(),
                 paths=float(paths), dist5=dist5.numpy(), px2=px2.numpy(),
                 lt5=lt5.numpy())
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, 2, str(d / "store"), str(d)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
        assert p.exitcode == 0, p.exitcode
    return [dict(np.load(d / f"r{r}.npz")) for r in range(2)]


def _passes(sc, passes):
    return [render_pass(sc, p, SEED, DEPTH, device="cpu") for p in passes]


def test_ranks_agree(two_ranks):
    a, b = two_ranks
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_pixel_sharded_matches_render_pass(two_ranks):
    sc = _scene()
    ref, rays = render_pass(sc, 3, SEED, DEPTH, device="cpu")
    np.testing.assert_allclose(two_ranks[0]["pix"], ref.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert int(two_ranks[0]["pix_rays"]) == int(rays)


def test_sample_sharded_is_mean_of_passes(two_ranks):
    """Pass 1 on 2 ranks: passes 2 and 3 (pass * n + rank)."""
    outs = _passes(_scene(), [2, 3])
    ref = (outs[0][0] + outs[1][0]) / 2
    np.testing.assert_allclose(two_ranks[0]["smp"], ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert int(two_ranks[0]["smp_rays"]) == sum(int(r) for _, r in outs)


def test_lt_sharded_matches_sequential_lt_passes(two_ranks):
    sc = _scene()
    imgs = [lt_pass(sc, p, SEED, N_PATHS, DEPTH, device="cpu")[0]
            for p in (2, 3)]
    np.testing.assert_allclose(two_ranks[0]["lt"], ((imgs[0] + imgs[1]) / 2)
                               .numpy(), rtol=1e-6, atol=1e-7)
    assert float(two_ranks[0]["paths"]) == 2 * N_PATHS


def test_distributed_loops_keep_n_calls(two_ranks):
    """render_distributed keeps the JAX package's n_calls = max(spp // n, 1):
    spp 5 on 2 ranks makes 2 calls, passes 0-3; the LT loop likewise."""
    sc = _scene()
    outs = _passes(sc, range(4))
    ref = sum(o[0] for o in outs) / 4
    np.testing.assert_allclose(two_ranks[0]["dist5"], ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    px = sum(o[0] for o in outs[:2]) / 2
    np.testing.assert_allclose(two_ranks[0]["px2"], px.numpy(), rtol=1e-6,
                               atol=1e-7)
    lts = [lt_pass(sc, p, SEED, N_PATHS, DEPTH, device="cpu")[0]
           for p in range(4)]
    lref = ((lts[0] + lts[1]) / 2 + (lts[2] + lts[3]) / 2) / 2
    np.testing.assert_allclose(two_ranks[0]["lt5"], lref.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_world_of_one_in_process():
    """No group and no torchrun variables: make_mesh makes a gloo world of
    1 and close() destroys it; a loop without a mesh makes and closes its
    own."""
    import torch.distributed as dist

    sc = _scene()
    mesh = pm.make_mesh("cpu")
    try:
        assert (mesh.rank, mesh.size, mesh.owned) == (0, 1, True)
        assert dist.get_backend() == "gloo"
        img = pm.render_distributed(sc, 3, mesh=mesh, seed=SEED,
                                    max_depth=DEPTH)
    finally:
        mesh.close()
    assert not dist.is_initialized()
    ref = sum(o[0] for o in _passes(sc, range(3))) / 3
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    lt = pm.render_lt_distributed(sc, 2, seed=SEED, paths_per_pass=N_PATHS,
                                  max_depth=DEPTH, device="cpu")
    assert not dist.is_initialized()
    lts = [lt_pass(sc, p, SEED, N_PATHS, DEPTH, device="cpu")[0] for p in (0, 1)]
    np.testing.assert_allclose(lt.numpy(), ((lts[0] + lts[1]) / 2).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_env_rendezvous(monkeypatch):
    """torchrun's variables set: make_mesh joins through env://."""
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                 ("RANK", "0"), ("WORLD_SIZE", "1")):
        monkeypatch.setenv(k, v)
    mesh = pm.make_mesh("cpu")
    try:
        assert (mesh.rank, mesh.size, mesh.owned) == (0, 1, True)
    finally:
        mesh.close()
    assert not dist.is_initialized()


def test_pixel_count_must_divide():
    fake = pm.Mesh(group=None, rank=0, size=3, device=torch.device("cpu"))
    with pytest.raises(ValueError):
        pm.render_pass_pixel_sharded(_scene(), 0, SEED, fake, DEPTH)


@pytest.mark.parametrize("mode", ["sample", "pixel"])
def test_world_of_one_matches_jax_mesh(mode):
    """render_distributed on a gloo world of 1 against the JAX package's on
    make_mesh(jax.devices()[:1]): the same scene bytes, spp 3 (three calls
    in either mode, passes 0-2), the sample keying of _trace_pixels."""
    import jax

    from hydracore_tpu.parallel import mesh as jm
    from hydracore_tpu.scene.procedural import SceneBuilder as JaxBuilder
    from tests.test_torch_scene import to_port

    js = _scene(JaxBuilder)
    ref = np.asarray(jm.render_distributed(
        js, 3, mesh=jm.make_mesh(jax.devices()[:1]), seed=SEED,
        max_depth=DEPTH, mode=mode))
    img = pm.render_distributed(to_port(js), 3, seed=SEED, max_depth=DEPTH,
                                mode=mode, device="cpu").numpy()
    assert img.shape == (8, 8, 3) and img.mean() > 0.01
    agree = (np.abs(img - ref).max(axis=-1) <= 1e-3).mean()
    assert agree >= 0.99, agree
