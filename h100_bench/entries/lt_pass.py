"""Entry `lt_pass`: light tracing, one pass of `paths_per_step` light
paths a step (`integrators/lt.py:lt_pass`), splatted into the frame; the
pass index advances by one a step. A sampling unit is a light path (a
pass of W x H paths is one sample a pixel).

Check: once the window has closed, the last pass and `check_passes` - 1
passes drawn from the seed among the first `early` are rendered by the
reference and compared pixel by pixel over the pixels either side lit
(compare.py). Only those passes' images are kept."""
from __future__ import annotations

import numpy as np

from h100_bench import compare
from h100_bench.reference import render as ref

WARM_PASS = 1 << 30


class Entry:
    unit = "light paths"

    def __init__(self, scene, recipe, traffic: dict, seed: int, device):
        from hydracore_tpu_torch.integrators import lt

        self.lt, self.scene, self.seed, self.device = lt, scene, seed, device
        self.n = traffic["paths_per_step"]
        self.depth = recipe.depth
        self.units_per_step = self.n
        self.traffic = traffic
        c = traffic["check"]
        g = np.random.default_rng([seed & 0xFFFFFFFF, 0x1765])
        self.early = set(g.permutation(c["early"])[:c["passes"] - 1].tolist())
        self.kept = {}
        self.last = None

    def _render(self, pass_idx: int):
        return self.lt.lt_pass(self.scene, pass_idx, self.seed, self.n,
                               max_depth=self.depth, device=self.device)[0]

    def warm(self):
        self._render(WARM_PASS)

    def step(self, i: int):
        return self._render(i)

    def record(self, i: int, out) -> None:
        if i in self.early:
            self.kept[i] = out
        self.last = (i, out)

    def trace_targets(self):
        return [(self.lt, "closest_hit", "closest"),
                (self.lt, "any_hit", "any")]

    def release(self) -> None:
        self.scene = None

    def check(self, flat, n_steps: int, seed: int, tol: float,
              control=None) -> dict:
        S = ref.Scene(flat, self.device)
        C = None if control is None else ref.Scene(flat, self.device, control)
        got = dict(self.kept)
        if self.last is not None:
            got[self.last[0]] = self.last[1]
        passes = sorted(p for p in self.early if p < n_steps)
        passes.append(n_steps - 1)
        errs = []
        for p in sorted(set(passes)):
            want = ref.lt_pass(S, p, seed, self.n)
            out = got[p] if C is None else ref.lt_pass(C, p, seed, self.n)
            errs.append(compare.errors(out, want, lit_only=True))
        return compare.judge(errs, tol)
