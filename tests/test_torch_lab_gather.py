"""Kernel lab T7 (hydracore_tpu_torch/tools/bench_pallas_gather.py) against
the JAX tool tools/bench_pallas_gather.py on its hard inputs, on the CPU.

The JAX tool is loaded as tests/test_torch_lab.py loads it (pallas_call in
interpret mode) and run on the first 512 rows (one BLK) of each case of
t7.adversarial_inputs, with its S, R and ITERS set to the case's. The port
runs gather_plain (CPU tensors); the card holds the kernels against the
same plain version in tests/test_torch_card.py.

Tolerance: bit for bit, any NaN matching any NaN. Two cases test what the
port once computed otherwise: idx + it near 2^31 wraps as int32 (S 3000),
and onehot's NaN columns, where the one-hot product adds 0 * inf.

XLA:CPU departs from the tool's source in two places, and the tool is held
to what it computes (ROADMAP.md §C, "The tools as XLA:CPU runs them"):
  * it flushes subnormals to zero, so the plain version meets the case's
    pool with its subnormals flushed to signed zeros (no case makes a
    subnormal from normal values);
  * it drops taa's `zeros + rows` add, so a sum whose every term is -0.0
    comes out -0.0 where the source gives 0 + (-0.0) = +0.0 (onehot's terms
    come out of a matrix product whose sums of zeros are +0.0).
With 0 iterations the tool's printed rate divides by R * ITERS = 0: it
raises after its output is computed, and the output is compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore_tpu_torch.tools import bench_pallas_gather as t7
from tests.test_torch_lab import _JitRecorder, _load_tool

torch.set_num_threads(1)

CASES = t7.adversarial_inputs("cpu")


def _flushed(p: np.ndarray) -> np.ndarray:
    """p with its subnormals replaced by zeros of their sign."""
    tiny = np.abs(p) < np.finfo(np.float32).tiny
    return np.where(tiny, np.copysign(np.float32(0), p), p).astype(np.float32)


def _tool_form(pool, idx, iters, onehot):
    """gather_plain as XLA:CPU runs the tool: on the flushed pool, and for
    taa -0.0 where every term is -0.0."""
    out = t7.gather_plain(pool, idx, iters, onehot)
    if onehot or iters == 0:
        return out
    p = pool.numpy()
    negz = torch.tensor(((p == 0) & np.signbit(p)).astype(np.float32))
    every = t7.gather_plain(negz, idx, iters) == iters
    return torch.where(every & (out == 0), -0.0, out)


@pytest.mark.parametrize("kern", ["taa", "onehot"])
@pytest.mark.parametrize("case", list(CASES))
def test_gather_adversarial_matches_tool(case, kern, monkeypatch):
    pool, idx, iters = CASES[case]
    mod = _load_tool("bench_pallas_gather", monkeypatch)
    n = mod.BLK
    monkeypatch.setattr(mod, "R", n)
    monkeypatch.setattr(mod, "S", pool.shape[0])
    monkeypatch.setattr(mod, "ITERS", iters)
    p = _flushed(pool.numpy())
    i = idx.numpy()[:n]
    rec = _JitRecorder()
    monkeypatch.setattr(jax, "jit", rec.jit)
    try:
        mod.run(getattr(mod, f"kern_{kern}"), kern, jnp.asarray(p),
                jnp.asarray(i))
    except ZeroDivisionError:
        assert iters == 0
    (out_j,) = rec.outs
    want = _tool_form(torch.tensor(p), torch.tensor(i), iters,
                      kern == "onehot")
    assert t7.same_bits(torch.tensor(np.asarray(out_j)), want)


def test_adversarial_cases_cover_the_hard_inputs():
    """The cases hold what they claim: the int32 ends and the rows that
    wrap, both paths of the card, R a multiple of no warp or CTA size,
    and the pool's hard values."""
    for name, (pool, idx, iters) in CASES.items():
        n, s = idx.shape[0], pool.shape[0]
        i = idx.reshape(-1)[:512].tolist()
        assert {-2**31, 2**31 - 1, 2**31 - 2, 2**31 - 9, 2**31 - 16} <= set(i)
        assert min(i) < 0 and max(i) >= s and n % 8 != 0
        assert t7.uses_window(n, s, iters) == (
            name in ("wrap_3000", "wrap_4096", "nonfinite", "small_pool"))
    assert t7.wrapping_rows(CASES["wrap_3000"][1], 3000) > 0
    assert t7.wrapping_rows(CASES["small_pool"][1], 5) > 0
    assert t7.wrapping_rows(CASES["wrap_4096"][1], 4096) == 0
    assert CASES["direct"][0].shape[0] > CASES["direct"][1].shape[0]
    assert t7.uses_window(t7.R, t7.S) and not t7.uses_window(t7.R, t7.S, 66)
    assert [CASES[k][2] for k in ("iters0", "iters1", "small_pool")] == [0, 1, 16]
    p = CASES["nonfinite"][0]
    b = p.to(torch.bfloat16).float()
    assert torch.isnan(p).any() and torch.isinf(p).any()
    assert torch.isfinite(p[9, 5]) and torch.isinf(b[9, 5])  # 3.4e38
    assert ((p == 0) & torch.signbit(p)).any()
    sub = (p != 0) & (p.abs() < torch.finfo(torch.float32).tiny)
    assert sub.sum() >= 32
    assert torch.isinf(p[20:36, 15].sum())  # a window's sum overflows
    # ties: the bf16 rounding goes to the even neighbour, up and down
    assert b[16, 13] == 1.0 and b[17, 13] == 1 + 2**-6


def test_gather_rules_of_the_function():
    """gather_plain's two rules by hand: the int32 wrap of idx + it, and
    onehot's NaN terms."""
    pool = torch.arange(3000 * 128, dtype=torch.float32).reshape(3000, 128)
    idx = torch.tensor([[2**31 - 1]], dtype=torch.int32)
    out = t7.gather_plain(pool, idx, 2)
    # 2^31 - 1 then -2^31: rows 2647 and 352 (floor modulo 3000), not 2648
    assert torch.equal(out[0], pool[2647] + pool[352])
    pool = torch.ones(4, 128)
    pool[1, 0], pool[2, 1] = float("inf"), float("nan")
    one = torch.tensor([[1]], dtype=torch.int32)
    out = t7.gather_plain(pool, one, 1, onehot=True)
    assert out[0, 0] == float("inf") and torch.isnan(out[0, 1])
    assert torch.equal(out[0, 2:], torch.ones(126))
    out = t7.gather_plain(pool, one, 2, onehot=True)  # rows 1 and 2
    assert torch.isnan(out[0, :2]).all() and (out[0, 2:] == 2).all()
