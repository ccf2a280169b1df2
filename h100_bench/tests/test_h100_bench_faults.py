"""`correct` comes out false for the control and for each fault a cell can
have, on the CPU at a size a test run holds: the harness's whole run
(set-up, window, check) with the timed path broken underneath. The
control is the reference, computed in bfloat16, in the port's place. The
faults: a step that returns its state unchanged; half of a step's samples
left out and the mean taken over the rest; an answer altered where it is
produced. One card and no exchange between chips, so that fault has no
place here."""
import pytest
import torch

from h100_bench.tests.conftest import small_run

CELLS = ["cornell.pt_offline", "cornell.lt"]


def test_sound_runs_are_correct():
    out = small_run("cornell.lt")
    assert out["correct"], out["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_is_not_correct(cell):
    out = small_run(cell, control=torch.bfloat16)
    assert not out["correct"], out["check"]


def _unchanged(monkeypatch, cell):
    from hydracore_tpu_torch.integrators import lt, pt

    mod, name = (lt, "lt_pass") if cell == "cornell.lt" else \
        (pt, "render_tile_production")
    real, first = getattr(mod, name), []

    def stuck(*a, **kw):
        out = real(*a, **kw)
        if not first:
            first.append(out)
        return first[0]

    monkeypatch.setattr(mod, name, stuck)


def _half(monkeypatch, cell):
    from hydracore_tpu_torch.integrators import lt, pt

    if cell == "cornell.lt":
        real = lt._lt_pass
        monkeypatch.setattr(lt, "_lt_pass", lambda s, i, seed, n, d:
                            real(s, i, seed, n // 2, d))
        return
    real = pt._production_rays

    def first_half(scene, pix_ids, pass_base, seed, k):
        o, d, sidx = real(scene, pix_ids, pass_base, seed, k)
        h = k // 2
        keep = (torch.arange(o.shape[0]) % k) % h + \
            (torch.arange(o.shape[0]) // k) * k
        return o[keep], d[keep], sidx[keep]

    monkeypatch.setattr(pt, "_production_rays", first_half)


def _altered(monkeypatch, cell):
    from hydracore_tpu_torch.integrators import lt, pt

    if cell == "cornell.lt":
        real = lt.sample_light_fwd

        def brighter(scene, l_idx, rnds):
            ls = real(scene, l_idx, rnds)
            every8 = (torch.arange(ls.radiance.shape[0]) % 8 == 0)[:, None]
            return ls._replace(radiance=torch.where(every8, 2 * ls.radiance,
                                                    ls.radiance))

        monkeypatch.setattr(lt, "sample_light_fwd", brighter)
        return
    real = pt.pt_trace

    def brighter(*a, **kw):
        color, rays = real(*a, **kw)
        every8 = (torch.arange(color.shape[0]) % 8 == 0)[:, None]
        return torch.where(every8, 2 * color, color), rays

    monkeypatch.setattr(pt, "pt_trace", brighter)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_the_samples",
                              "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    # three steps at least: a first, a middle and a last step to check
    out = small_run(cell, seconds=0.0, min_steps=3)
    assert out["attempted"] >= 3
    assert not out["correct"], out["check"]
