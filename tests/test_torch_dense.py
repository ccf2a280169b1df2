"""The dense route's contract (ops/traverse_dense.py), held on its plain
version on the CPU: the contract that the card's kernel
(csrc/traverse_dense.cu) must meet word for word, which
tests/test_torch_card.py checks on the card.

  * the first slot wins among equal t;
  * a dead ray gives the miss record (+inf, -1, +0.0, +0.0);
  * a scalar t_max gives what the same value as a tensor gives;
  * any hit is closest hit's tri >= 0;
  * the block path (BLOCK_SLOTS made small) gives what one block gives in
    float32, and under f64 a miss stays a miss whatever t_max is;
  * CPU tensors run the plain version and launch nothing;
  * the kernel's wrapper refuses inputs the kernel does not take.

Every comparison is exact: the same arithmetic on the same values. The
cases come from tests/dense_cases.py.
"""
import pytest
import torch
from dense_cases import active_mask, dense_case, same_words

from hydracore_tpu_torch.ops import traverse_dense as td
from hydracore_tpu_torch.ops.intersect import ray_args

torch.set_num_threads(1)


def plain(case, f64=False, active=None, t_max=None):
    tri9f, slot_tri, ro, rd, tm = case
    tm, act = ray_args(ro, tm if t_max is None else t_max, active)
    return td.traverse_dense_plain(tri9f, slot_tri, ro, rd, tm, act, f64)


@pytest.fixture(scope="module")
def case():
    return dense_case(11)


@pytest.mark.parametrize("f64", [False, True])
def test_first_slot_wins_among_equal_t(case, f64):
    tri9f, slot_tri, ro, rd, tm = case
    t, tri, _, _ = plain(case, f64, t_max=1e30)
    S = slot_tri.shape[0]
    first = int(slot_tri[1])  # the duplicate's first slot
    later = {int(slot_tri[S // 2 + 3]), int(slot_tri[S - 2])}
    aim = slice(0, ro.shape[0] // 4)
    assert (tri[aim] == first).sum() > 20
    assert not any((tri == k).any() for k in later)


@pytest.mark.parametrize("f64", [False, True])
def test_dead_rays_give_the_miss_record(case, f64):
    act = active_mask("random", case[2].shape[0])
    t, tri, u, v = plain(case, f64, active=act)
    dead = ~act
    assert same_words(t[dead], torch.full_like(t[dead], float("inf")))
    assert torch.equal(tri[dead], torch.full_like(tri[dead], -1))
    for x in (u, v):
        assert same_words(x[dead], torch.zeros_like(x[dead]))
    assert (tri[act] >= 0).sum() > 100  # the live rays do hit


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("value", [1e30, 1.5, float("inf"), 1e39, 3.0e38,
                                   0.0, -2.0, float("nan")])
def test_scalar_t_max_equals_the_same_value_as_a_tensor(case, f64, value):
    R = case[2].shape[0]
    got = plain(case, f64, t_max=value)
    tensor = torch.as_tensor(value, dtype=torch.float32).expand(R).clone()
    want = plain(case, f64, t_max=tensor)
    assert all(same_words(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("t_max", ["tensor", "scalar"])
def test_any_hit_is_closest_hits_tri_at_least_0(case, f64, t_max):
    tri9f, slot_tri, ro, rd, tm = case
    tm = tm if t_max == "tensor" else 1.5
    act = active_mask("random", ro.shape[0])
    occ = td.traverse_dense(tri9f, slot_tri, ro, rd, tm, act, f64=f64,
                            any_hit_mode=True)
    _, tri, _, _ = td.traverse_dense(tri9f, slot_tri, ro, rd, tm, act, f64=f64)
    assert occ.dtype == torch.bool and torch.equal(occ, tri >= 0)
    assert occ.any() and not occ.all()


@pytest.mark.parametrize("block", [8, 16, 40])
def test_block_path_equals_one_block_in_float32(case, monkeypatch, block):
    """Blocks of `block` slots (the case has 96: several blocks, the last
    one partial for 40) against the whole scene in one block; the rays also
    in slices of a few hundred pairs."""
    one = plain(case)
    monkeypatch.setattr(td, "BLOCK_SLOTS", block)
    monkeypatch.setattr(td, "STEP_ELEMS", 512)
    blocked = plain(case)
    assert all(same_words(a, b) for a, b in zip(one, blocked))


def test_f64_miss_stays_a_miss_at_any_t_max(case):
    """A ray with no hit below t_max is a miss in float64 too, whatever
    t_max: no slot wins at the float32 3e38 a miss is held at."""
    for value in (float("inf"), 1e39, 3.0e38, 1e30):
        t, tri, u, v = plain(case, True, t_max=value)
        t32, tri32, _, _ = plain(case, False, t_max=value)
        miss = tri32 < 0
        assert miss.sum() > 50
        assert torch.equal(tri[miss], torch.full_like(tri[miss], -1))
        assert torch.isinf(t[miss]).all() and (u[miss] == 0).all()
        assert float((tri == tri32).float().mean()) > 0.99


@pytest.mark.parametrize("any_hit", [False, True])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(case, any_hit):
    from types import SimpleNamespace

    tri9f, slot_tri, ro, rd, tm = case
    scene = SimpleNamespace(wbvh_tri9f=tri9f, wbvh_slot_tri=slot_tri,
                            settings=None)
    td.reset_launch_counts()
    act = active_mask("random", ro.shape[0])
    if any_hit:
        got = td.any_hit(scene, ro, rd, tm, act)
        assert torch.equal(got, plain(case, active=act)[1] >= 0)
    else:
        got = td.closest_hit(scene, ro, rd, active=act)
        want = plain(case, active=act, t_max=1e30)
        assert all(same_words(a, b) for a, b in zip(got, want))
    assert (td.closest_launches, td.any_launches) == (0, 0)


@pytest.mark.parametrize("fault", ["tri9f_shape", "slot_tri_shape",
                                   "ray_shape", "ray_dtype", "active_shape",
                                   "active_dtype", "slot_tri_dtype"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(case, fault):
    tri9f, slot_tri, ro, rd, tm = case
    args = dict(tri9f=tri9f, slot_tri=slot_tri, ray_o=ro, ray_d=rd,
                t_max=tm, active=None, f64=False, any_hit_mode=False)
    if fault == "tri9f_shape":
        args["tri9f"] = tri9f.reshape(-1, 64)
    elif fault == "slot_tri_shape":
        args["slot_tri"] = slot_tri[:-8]
    elif fault == "ray_shape":
        args["ray_d"] = rd[:-1]
    elif fault == "ray_dtype":
        args["ray_o"] = ro.double()
    elif fault == "active_shape":
        args["active"] = torch.ones(3, dtype=torch.bool)
    elif fault == "active_dtype":
        args["active"] = torch.ones(ro.shape[0], dtype=torch.int32)
    else:
        args["slot_tri"] = slot_tri.long()
    td.reset_launch_counts()
    with pytest.raises(ValueError):
        td._dense_kernel(**args)
    assert (td.closest_launches, td.any_launches) == (0, 0)
