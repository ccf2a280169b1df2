"""The span and counter facility (hydracore_tpu_torch/utils/spans.py) on
the CPU: the span tree of a production tile and of an LT pass on a
cornell box at 16x16 built with SceneBuilder, recording off (nothing
recorded, the same bits), the live-ray counter against pt_trace's own, the
traversal kernels' launch counters read as module attributes, the
attribution of device operations and idle gaps on synthetic intervals, and
the host-sync record fed a synthetic sync warning."""
import os
import warnings

import pytest
import torch

from hydracore_tpu_torch.integrators import lt, pt
from hydracore_tpu_torch.ops import traverse_cluster as tc
from hydracore_tpu_torch.ops import traverse_packet as tp
from hydracore_tpu_torch.scene.procedural import SceneBuilder
from hydracore_tpu_torch.utils import spans

W = 16
SEED = 2**31 + 77
DEPTH = 5


def _build():
    b = SceneBuilder()
    m = b.lambert([0.6, 0.6, 0.6])
    red = b.lambert([0.7, 0.15, 0.1])
    green = b.lambert([0.15, 0.6, 0.1])
    b.add_box_interior(2.0, m, m, m, red, green)
    b.rect_light([0, 1.95, 0], 0.6, 0.6, [10.0, 10.0, 10.0])
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=W,
                   height=W, trace_depth=DEPTH)


@pytest.fixture(scope="module")
def scene():
    return _build()


def _tile(scene):
    ids = torch.arange(0, 2 * W, dtype=torch.int64)
    return pt._tile_production(scene, ids, 0, SEED, 8, DEPTH)


def _lt(scene):
    return lt._lt_pass(scene, 3, SEED, 2048, DEPTH)


def _paths(got):
    return [spans.path_of(got.spans, i) for i in range(len(got.spans))]


def _parent_name(got, i):
    p = got.spans[i].parent
    return got.spans[p].name if p >= 0 else None


def test_a_tile_is_one_step_of_eye_rays_bounces_and_resolve(scene):
    with spans.recording():
        _tile(scene)
    got = spans.take()
    roots = [s for s in got.spans if s.parent < 0]
    assert [s.name for s in roots] == ["pt.tile"]
    assert {s.step for s in got.spans} == {0}
    kids = [s for s in got.spans if s.parent == 0]
    assert [s.name for s in kids] == (["pt.eye_rays"] + ["pt.bounce"] * DEPTH
                                      + ["pt.resolve"])
    assert [s.attrs["depth"] for s in kids[1:-1]] == list(range(DEPTH))
    for i, s in enumerate(got.spans):
        assert s.start <= s.end
        if s.parent >= 0:
            p = got.spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
        if s.name.startswith("trace."):
            assert _parent_name(got, i) in ("pt.bounce", "pt.nee")
            assert s.attrs == {"route": "dense"}
    paths = _paths(got)
    # the dense route sorts nothing; the last depth neither shadows nor
    # samples a next ray
    assert paths.count("pt.tile/pt.bounce/trace.closest") == DEPTH
    assert paths.count("pt.tile/pt.bounce/pt.nee/trace.any") == DEPTH - 1
    assert paths.count("pt.tile/pt.bounce/pt.shade") == DEPTH
    assert paths.count("pt.tile/pt.bounce/pt.next") == DEPTH - 1
    assert "pt.tile/pt.bounce/pt.sort" not in paths


def test_an_lt_pass_is_one_step_of_emission_and_bounces(scene):
    with spans.recording():
        _lt(scene)
        _lt(scene)
    got = spans.take()
    roots = [i for i, s in enumerate(got.spans) if s.parent < 0]
    assert [got.spans[i].name for i in roots] == ["lt.pass", "lt.pass"]
    assert [got.spans[i].step for i in roots] == [0, 1]
    for i, s in enumerate(got.spans):
        r = i
        while got.spans[r].parent >= 0:
            r = got.spans[r].parent
        assert s.step == got.spans[r].step
    first = [s for s in got.spans if s.parent == roots[0]]
    assert [s.name for s in first] == ["lt.emit"] + ["lt.bounce"] * (DEPTH - 1)
    paths = _paths(got)
    n = 2 * (DEPTH - 1)
    assert paths.count("lt.pass/lt.bounce/trace.closest") == n
    assert paths.count("lt.pass/lt.bounce/lt.connect/trace.any") == n
    for name in ("lt.shade", "lt.connect", "lt.splat"):
        assert paths.count(f"lt.pass/lt.bounce/{name}") == n
    assert paths.count("lt.pass/lt.bounce/lt.next") == n - 2


def test_a_scene_build_is_a_span_with_a_child_a_stage():
    with spans.recording():
        _build()
    got = spans.take()
    assert _paths(got) == ["scene.build"] + [
        f"scene.build/scene.{k}" for k in ("bvh", "layout", "lights",
                                           "camera")]


@pytest.mark.parametrize("run", [_tile, _lt], ids=["pt_tile", "lt_pass"])
def test_off_records_nothing_and_on_gives_the_same_bits(scene, run):
    spans.take()
    off = run(scene)
    got = spans.take()
    assert got.spans == [] and got.counters == {} and got.syncs == {}
    with spans.recording():
        on = run(scene)
    assert spans.take().spans
    run(scene)
    assert spans.take().spans == []
    off, on = (x if isinstance(x, tuple) else (x,) for x in (off, on))
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_live_rays_count_what_the_path_tracer_traces(scene):
    with spans.recording():
        _, rays = _tile(scene)
    got = spans.take()
    assert got.counters["trace.live_rays"] == int(rays) > 0


@pytest.mark.parametrize("mod", [tc, tp], ids=["cluster", "packet"])
def test_launch_counters_read_as_module_attributes(mod):
    name = mod.__name__.rsplit(".", 1)[1]
    mod.reset_launch_counts()
    assert all(getattr(mod, k) == 0 for k in mod.LAUNCH_COUNTERS)
    spans.bump(f"{name}.closest_launches")
    spans.bump(f"{name}.closest_launches")
    spans.bump(f"{name}.any_launches")
    assert (mod.closest_launches, mod.any_launches) == (2, 1)
    with spans.recording():
        spans.bump(f"{name}.any_launches")
    assert spans.take().counters == {f"{name}.any_launches": 1}
    assert mod.any_launches == 2
    mod.reset_launch_counts()
    assert (mod.closest_launches, mod.any_launches) == (0, 0)
    with pytest.raises(AttributeError):
        mod.no_such_counter


def _span(name, start, end, parent=-1):
    s = spans.Span(name, start, parent, 0, {})
    s.end = end
    return s


# a root [0, 100) with children a [10, 40) and b [40, 70); nothing open
# in [100, 120); a second root [120, 150)
SYNTH = [_span("r", 0, 100), _span("a", 10, 40, 0), _span("b", 40, 70, 0),
         _span("s", 120, 150)]


def test_segments_give_the_innermost_span_at_each_time():
    assert spans.segments(SYNTH) == [(0, 10, 0), (10, 40, 1), (40, 70, 2),
                                     (70, 100, 0), (120, 150, 3)]


@pytest.mark.parametrize("case", ["gap_over_two_spans", "gap_in_no_span",
                                  "launch_on_a_boundary"])
def test_attribution_on_synthetic_intervals(case):
    if case == "gap_over_two_spans":
        # device busy [0, 25) and [55, 200): the gap [25, 55) is 15 ns in
        # a, 15 ns in b
        ops = [("k0", 0, 25, 1), ("k1", 55, 145, 2)]
        got = spans.attribute(SYNTH, ops, {1: 5, 2: 50})
        assert got["r"]["device_s"] == pytest.approx(25e-9)
        assert got["r/b"]["device_s"] == pytest.approx(145e-9)
        assert got["r/a"]["idle_s"] == pytest.approx(15e-9)
        assert got["r/b"]["idle_s"] == pytest.approx(15e-9)
        assert "r/a" in got and got["r/a"]["ops"] == 0
    elif case == "gap_in_no_span":
        # the gap [90, 130) is 10 ns in r, 20 outside, 10 in s; a launch
        # at 110 is outside, one with no launch recorded too
        ops = [("k0", 50, 40, 1), ("k1", 130, 5, 2), ("k2", 135, 5, 9)]
        got = spans.attribute(SYNTH, ops, {1: 45, 2: 110})
        assert got["r"]["idle_s"] == pytest.approx(10e-9)
        assert got[spans.OUTSIDE]["idle_s"] == pytest.approx(20e-9)
        assert got["s"]["idle_s"] == pytest.approx(10e-9)
        assert got["r/b"]["ops"] == 1
        assert got[spans.OUTSIDE]["ops"] == 2
        assert got[spans.OUTSIDE]["device_s"] == pytest.approx(10e-9)
    else:
        # spans are half-open: a launch at a's end (b's start) is b's, one
        # at r's end is outside
        ops = [("k0", 200, 1, 1), ("k1", 210, 1, 2), ("k2", 220, 1, 3)]
        got = spans.attribute(SYNTH, ops, {1: 40, 2: 10, 3: 100})
        assert (got["r/b"]["ops"], got["r/a"]["ops"],
                got[spans.OUTSIDE]["ops"]) == (1, 1, 1)
    total = sum(r["device_s"] for r in got.values())
    assert total == pytest.approx(sum(o[2] for o in ops) / 1e9)


def _port_frame(src: str):
    """Code whose frames lie in a file of the port (the file need not
    exist: a site is read from the code's file name)."""
    where = os.path.join(os.path.dirname(spans.__file__), "sync_probe.py")
    return compile(src, where, "exec")


def test_a_sync_warning_counts_at_its_port_site_and_span():
    msg = "called a synchronizing CUDA operation"
    code = _port_frame(f"import warnings\nwarnings.warn({msg!r})\n")
    with warnings.catch_warnings(record=True) as outer:
        warnings.simplefilter("always")
        with spans.recording():
            with spans.span("probe"):
                exec(code, {})
                warnings.warn(msg)  # from this file: not the port's
                warnings.warn("something else")
            exec(code, {})
    got = spans.take()
    assert got.syncs == {
        ("hydracore_tpu_torch/utils/sync_probe.py:2", "probe"): 1,
        ("hydracore_tpu_torch/utils/sync_probe.py:2", spans.OUTSIDE): 1}
    assert [str(w.message) for w in outer] == ["something else"]


def test_recording_does_not_nest():
    with spans.recording():
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    spans.take()
