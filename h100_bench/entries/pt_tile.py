"""Entry `pt_tile`: offline path tracing, one production tile a step.

A step is `integrators/pt.py:render_tile_production` over one tile of
`tile_pixels` pixels at `k_samples` samples a pixel (a wavefront of
tile_pixels x k_samples rays). The frame's tiles are rows of pixels in
raster order; the window takes them `tile_stride` apart (0, n / s,
2n / s, ..., then 1, n / s + 1, ...), so every `tile_stride` consecutive
steps spread over the frame, and each pass over the frame takes the next
k_samples samples of every pixel. A sampling unit is a camera sample.

Check: once the window has closed, `check_tiles` of the completed steps
(the first and the last among them) and `check_pixels` pixels of each,
drawn from the seed, are rendered by the reference and compared pixel by
pixel (compare.py)."""
from __future__ import annotations

import numpy as np
import torch

from h100_bench import compare
from h100_bench.reference import render as ref

WARM_PASS = 1 << 30  # samples no window step draws


class Entry:
    unit = "camera samples"

    def __init__(self, scene, recipe, traffic: dict, seed: int, device):
        from hydracore_tpu_torch.integrators import pt

        self.pt, self.scene, self.seed, self.device = pt, scene, seed, device
        self.P = traffic["tile_pixels"]
        self.K = traffic["k_samples"]
        self.depth = recipe.depth
        self.n_pix = recipe.width * recipe.height
        self.n_tiles = -(-self.n_pix // self.P)
        self.stride = traffic["tile_stride"]
        if self.n_tiles % self.stride:
            raise ValueError(f"{self.n_tiles} tiles do not split into "
                             f"{self.stride} bands")
        self.units_per_step = self.P * self.K
        self.traffic = traffic
        self.kept = {}

    def tile(self, i: int) -> tuple[torch.Tensor, int]:
        """Pixel ids and first sample of window step i."""
        c, rnd = i % self.n_tiles, i // self.n_tiles
        t = (c % self.stride) * (self.n_tiles // self.stride) + c // self.stride
        start = t * self.P
        ids = torch.arange(start, min(start + self.P, self.n_pix),
                           dtype=torch.int64, device=self.device)
        return ids, rnd * self.K

    def _render(self, ids, pass_base: int):
        return self.pt.render_tile_production(
            self.scene, ids, pass_base, self.seed, k_samples=self.K,
            max_depth=self.depth, device=self.device)

    def warm(self):
        self._render(self.tile(0)[0], WARM_PASS)

    def step(self, i: int):
        return self._render(*self.tile(i))

    def record(self, i: int, out) -> None:
        self.kept[i] = out

    def trace_targets(self):
        return [(self.pt, "closest_hit", "closest"),
                (self.pt, "any_hit", "any")]

    def release(self) -> None:
        self.scene = None

    def picks(self, n_steps: int, seed: int):
        """[(step, pixel positions in its tile)] drawn from the seed."""
        c = self.traffic["check"]
        g = np.random.default_rng([seed & 0xFFFFFFFF, 0x7E57])
        ends = {0, n_steps - 1}
        others = [s for s in g.permutation(n_steps).tolist()
                  if s not in ends][:max(c["tiles"] - 2, 0)]
        steps = sorted(ends | set(others))
        out = []
        for s in steps:
            n = self.tile(s)[0].shape[0]
            pos = np.sort(g.permutation(n)[:c["pixels"]])
            out.append((s, torch.as_tensor(pos, device=self.device)))
        return out

    def check(self, flat, n_steps: int, seed: int, tol: float,
              control=None) -> dict:
        """{name: value} of the check (compare.judge). `control` (a
        dtype) puts the reference, computed in that precision, in the
        port's place."""
        S = ref.Scene(flat, self.device)
        C = None if control is None else ref.Scene(flat, self.device, control)
        errs = []
        for s, pos in self.picks(n_steps, seed):
            ids, base = self.tile(s)
            want = ref.pt_tile(S, ids[pos], base, seed, self.K)
            got = (self.kept[s][pos] if C is None
                   else ref.pt_tile(C, ids[pos], base, seed, self.K))
            errs.append(compare.errors(got, want))
        return compare.judge(errs, tol)
