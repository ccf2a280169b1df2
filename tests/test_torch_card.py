"""Tests of the port that need an NVIDIA GPU: kernels B1/B2 against their
plain twin, and the path tracer on the card against the CPU twins.

Each test skips without CUDA. The file imports nothing of the JAX package,
so it runs on a machine with the card:

    python -m pytest tests/test_torch_card.py -q

Tolerances: kernel and twin share their arithmetic (no fast math, no FMA
contraction), so t, slots and occlusion must be equal; the card's image
must agree with the CPU twins' image within 1e-3 on >= 99% of pixels.
"""
import numpy as np
import pytest
import torch

from hydracore_tpu_torch.integrators import pt
from hydracore_tpu_torch.ops import traverse_cluster as tc
from hydracore_tpu_torch.scene.procedural import SceneBuilder


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernels B1/B2 run only on the card")
    return torch.device("cuda")


def _rects_scene():
    """tests/test_traverse_cluster.py's 350 random rects."""
    rng = np.random.default_rng(7)
    b = SceneBuilder()
    m = b.lambert([0.7, 0.7, 0.7])
    for _ in range(350):
        b.add_rect(rng.uniform(-4, 4, 3), rng.uniform(-0.4, 0.4, 3),
                   rng.uniform(-0.4, 0.4, 3), m)
    return b.build(cam_pos=[0, 0, 10], cam_lookat=[0, 0, 0], width=8, height=8)


def _box_scene(size: int):
    b = SceneBuilder()
    m = b.lambert([0.65, 0.65, 0.65])
    b.add_box_interior(2.0, m, m, m, b.lambert([0.7, 0.12, 0.1]),
                       b.lambert([0.12, 0.55, 0.18]))
    glass = b.add_material(transp_color=np.array([0.95] * 3, np.float32),
                           transp_gloss=1.0, transp_ior=1.5)
    b.add_sphere([0.0, -1.2, 0.5], 0.8, glass)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [12.0] * 3)
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=size,
                   height=size, trace_depth=5)


@pytest.mark.parametrize("any_hit_mode", [False, True])
@pytest.mark.parametrize("r_blk", [tc.R_BLK, tc.R_BLK_BOUNCE])
def test_kernel_matches_twin(cuda, any_hit_mode, r_blk):
    sc = _rects_scene().to(cuda)
    rng = np.random.default_rng(3)
    R = 5000  # a ragged last block
    ro = torch.tensor(rng.uniform(-6, 6, (R, 3)), dtype=torch.float32, device=cuda)
    rd = torch.tensor(rng.normal(size=(R, 3)), dtype=torch.float32, device=cuda)
    rd = rd / rd.norm(dim=1, keepdim=True)
    act = torch.tensor(np.arange(R) % 7 != 0, device=cuda)
    t_max = torch.where(torch.arange(R, device=cuda) % 3 == 0, 4.0, 1e30)
    blocks, _ = tc._to_blocks(ro, rd, t_max, act, r_blk)
    pool = (sc.cl_bounds_oct, sc.cl_tris, sc.cl_oct_perm)
    before = (tc.closest_launches, tc.any_launches)
    t_k, s_k = tc.cluster_traverse(blocks, *pool, any_hit_mode=any_hit_mode)
    after = (tc.closest_launches, tc.any_launches)
    t_t, s_t = tc.cluster_traverse_plain(blocks, *pool,
                                         any_hit_mode=any_hit_mode)
    torch.cuda.synchronize()
    assert after[int(any_hit_mode)] == before[int(any_hit_mode)] + 1
    assert after[1 - int(any_hit_mode)] == before[1 - int(any_hit_mode)]
    assert 100 < int((s_k >= 0).sum()) < R
    assert torch.equal(s_k >= 0, s_t >= 0)
    assert torch.equal(t_k, t_t)
    if not any_hit_mode:
        assert torch.equal(s_k, s_t)


def test_wrapper_refuses_mixed_devices(cuda):
    sc = _rects_scene()
    blocks = torch.zeros((2, tc.R_BLK, 8), device=cuda)
    with pytest.raises(ValueError, match="cpu"):
        tc.cluster_traverse(blocks, sc.cl_bounds_oct, sc.cl_tris,
                            sc.cl_oct_perm)


def test_render_on_card_matches_cpu_twins(cuda):
    sc = _box_scene(32)
    before = (tc.closest_launches, tc.any_launches)
    img_card = pt.render(sc, spp=4, seed=777, device=cuda)
    assert tc.closest_launches > before[0] and tc.any_launches > before[1]
    img_cpu = pt.render(sc, spp=4, seed=777, device="cpu")
    img_card = img_card.cpu()
    assert torch.isfinite(img_card).all() and float(img_card.mean()) > 0.01
    agree = float(((img_card - img_cpu).abs().amax(dim=-1) <= 1e-3)
                  .float().mean())
    assert agree >= 0.99, agree
