"""scene.build_s: the span `scene.build` of the port's scene compiler
(SceneBuilder.build or scene.assemble), recorded when the span pass
assembles the recipe once more (spans_pass.py)."""
from h100_bench import spans_pass


def read(run):
    got = spans_pass.result(run)
    return None if got is None else got["build_s"]
