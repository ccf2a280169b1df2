"""The reference against the port's CPU path at 16x16 on one description:
PT tiles and LT passes agree within the comparison the benchmark's
`correct` uses. The reference imports nothing of the port; only this test
does."""
import copy

import pytest
import torch

from h100_bench import compare, harness
from h100_bench.reference import render as ref
from h100_bench.scenes import common as C

CPU = torch.device("cpu")


# the Cornell box with its blocks made glossy (GGX) and glass: the
# reference's other materials, which later configurations may use
GLOSSY = {"ggx": {"refl_color": [0.8, 0.7, 0.5], "refl_dist": 2,
                  "refl_alpha": 0.25},
          "glass": {"transp_color": [0.95, 0.95, 0.95], "transp_ior": 1.5}}


def _scenes(glossy: bool):
    cfg = copy.deepcopy({**harness.config("cornell"), "width": 16,
                         "height": 16})
    if glossy:
        cfg["materials"].update(GLOSSY)
        for o in cfg["objects"]:
            o["material"] = {"short_block": "glass", "tall_block": "ggx"}.get(
                o["name"], o["material"])
    mod = harness.recipe_module(cfg)
    rec = mod.recipe(cfg)
    return mod.to_port(rec), ref.Scene(C.flatten(rec), CPU)


def _judge(got, want, cell, lit_only=False):
    lim = harness.limits(cell)
    errs = [compare.errors(got, want, lit_only)]
    return compare.judge(errs, lim[compare.AGREE]), lim


@pytest.mark.parametrize("glossy,k", [(False, 8), (False, 64), (True, 8)],
                         ids=["lambert_k8", "lambert_k64", "glossy_k8"])
def test_pt_tile_matches_the_port(glossy, k):
    from hydracore_tpu_torch.integrators import pt

    port, S = _scenes(glossy)
    pix = torch.arange(0, 256, 1 if k == 8 else 4)
    got = pt.render_tile_production(port, pix, 64, 2**31 + 9, k_samples=k,
                                    max_depth=5, device="cpu")
    want = ref.pt_tile(S, pix, 64, 2**31 + 9, k)
    got_n, lim = _judge(got, want, "cornell.pt_offline")
    assert got_n[compare.SHARE] <= lim[compare.SHARE]
    assert want.sum() > 0


@pytest.mark.parametrize("glossy", [False, True], ids=["lambert", "glossy"])
def test_lt_pass_matches_the_port(glossy):
    from hydracore_tpu_torch.integrators import lt

    port, S = _scenes(glossy)
    got, _ = lt.lt_pass(port, 5, 77, 8192, 5, device="cpu")
    want = ref.lt_pass(S, 5, 77, 8192)
    assert (compare.errors(got, want, lit_only=True).numel()) > 100
    got_n, lim = _judge(got, want, "cornell.lt", lit_only=True)
    assert got_n[compare.SHARE] <= lim[compare.SHARE]


def test_reference_imports_nothing_of_the_port():
    import ast
    import os

    for f in os.listdir(os.path.dirname(ref.__file__)):
        if f.endswith(".py"):
            src = open(os.path.join(os.path.dirname(ref.__file__), f)).read()
            for node in ast.walk(ast.parse(src)):
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    mods = ([a.name for a in node.names]
                            if isinstance(node, ast.Import) else [node.module])
                    assert not any(m and m.startswith("hydracore")
                                   for m in mods)
