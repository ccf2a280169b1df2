"""The spans of integrators/bdpt.py on the CPU (utils/spans.py): one IBPT
pass is one `bdpt.pass` root with the phases bdpt.eye, bdpt.camera and
bdpt.light (one a depth), bdpt.connect and bdpt.splat; every `trace.*`
span of the pass lies in one of them; recording changes no bit of the
image."""
import pytest
import torch

from hydracore_tpu_torch.integrators import bdpt
from hydracore_tpu_torch.scene.procedural import SceneBuilder
from hydracore_tpu_torch.utils import spans

W = 16
SEED = 2**31 + 77
DEPTH = 4
PHASES = {"bdpt.eye", "bdpt.camera", "bdpt.light", "bdpt.connect",
          "bdpt.splat"}


@pytest.fixture(scope="module")
def scene():
    b = SceneBuilder()
    m = b.lambert([0.6, 0.6, 0.6])
    red = b.lambert([0.7, 0.15, 0.1])
    green = b.lambert([0.15, 0.6, 0.1])
    b.add_box_interior(2.0, m, m, m, red, green)
    b.rect_light([0, 1.95, 0], 0.6, 0.6, [10.0, 10.0, 10.0])
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=W,
                   height=W, trace_depth=DEPTH)


def _pass(scene, strategies="3way"):
    return bdpt.bdpt_pass(scene, 3, SEED, DEPTH, strategies, device="cpu")


@pytest.fixture(scope="module")
def recorded(scene):
    with spans.recording():
        img = _pass(scene)
    return img, spans.take()


def test_the_phases_nest_under_one_pass(recorded):
    _, got = recorded
    roots = [s for s in got.spans if s.parent < 0]
    assert [s.name for s in roots] == ["bdpt.pass"]
    assert roots[0].attrs == {"strategies": "3way"}
    kids = [s for s in got.spans if s.parent == 0]
    assert [s.name for s in kids] == (
        ["bdpt.eye"] + ["bdpt.camera"] * DEPTH + ["bdpt.light"] * (DEPTH - 1)
        + ["bdpt.connect", "bdpt.splat"])
    assert [s.attrs["depth"] for s in kids if s.name == "bdpt.camera"] == \
        list(range(DEPTH))
    assert [s.attrs["depth"] for s in kids if s.name == "bdpt.light"] == \
        list(range(DEPTH - 1))
    for s in got.spans:
        if s.name.startswith("bdpt.") and s is not roots[0]:
            assert spans.path_of(got.spans, got.spans.index(s)).startswith(
                "bdpt.pass/")
        assert s.start <= s.end
    for a, b in zip(kids, kids[1:]):
        assert a.end <= b.start


def test_every_trace_span_lies_in_a_phase(recorded):
    _, got = recorded
    traces = [i for i, s in enumerate(got.spans)
              if s.name.startswith("trace.")]
    # camera subpath: DEPTH closest; light: DEPTH - 1; NEE and t = 1 tests
    assert len(traces) == DEPTH + (DEPTH - 1) + (DEPTH - 1) + (DEPTH - 1)
    for i in traces:
        parent = got.spans[got.spans[i].parent]
        assert parent.name in PHASES, spans.path_of(got.spans, i)
        assert parent.start <= got.spans[i].start <= got.spans[i].end \
            <= parent.end
    anys = [spans.path_of(got.spans, i) for i in traces
            if got.spans[i].name == "trace.any"]
    assert set(anys) == {"bdpt.pass/bdpt.connect/trace.any"}
    assert got.counters["trace.live_rays"] > 0


def test_recording_changes_no_bit_of_the_image(scene, recorded):
    img, _ = recorded
    off = _pass(scene)
    assert torch.equal(img, off) and float(off.sum()) > 0
    assert spans.take().spans == []  # nothing recorded while off


def test_a_full_sbdpt_pass_has_the_same_phases(scene):
    with spans.recording():
        _pass(scene, "full")
    got = spans.take()
    names = {s.name for s in got.spans if s.parent == 0}
    assert names == PHASES
    assert got.spans[0].attrs == {"strategies": "full"}
