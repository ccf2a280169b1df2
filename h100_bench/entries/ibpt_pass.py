"""Entry `ibpt_pass`: instant bidirectional path tracing (IBPT), one pass a
step (`integrators/bdpt.py:bdpt_pass`, strategies "3way", the pass the
CLI's `-method ibpt` accumulates): one camera subpath and one light subpath
a pixel, the pass index advancing by one a step. A sampling unit is a
camera sample (a pass is one a pixel, so W x H lanes a step).

Check, once the window has closed, in two parts:

- the image: the last pass and `check_passes` - 1 passes drawn from the
  seed among the first `early` are rendered by the reference
  (reference/ibpt.py) and compared pixel by pixel over the pixels either
  side lit (compare.py). Only those passes' images are kept.
- the geometry: one ray through each pixel's centre, in Morton order, is
  cast by the port (before its scene is released) and by the reference's
  caster. A ray mismatches where one side hits and the other does not, or
  where the two hit distances differ by more than T_TOL of the
  reference's. The numbers are the mismatched share and the most
  mismatched rays in one 8 x 8 pixel tile (TILE consecutive Morton lanes):
  a surface lost or misplaced by a few pixels fills a tile, where rounding
  at silhouettes leaves single rays.
"""
from __future__ import annotations

import numpy as np
import torch

from h100_bench import compare
from h100_bench.reference import ibpt as ref
from h100_bench.scenes.common import camera_matrices

WARM_PASS = 1 << 30
T_TOL = 1e-4  # relative difference of two hit distances that still agree
TILE = 64  # consecutive Morton lanes: an 8 x 8 pixel tile
HIT_SHARE = "primary_hit_mismatch_share"
HIT_TILE = "primary_hit_tile_mismatch_max"
HIT_AGREE = "primary_hit_rel_err_agreeing_max"


def centre_rays(rec, device):
    """(o, d) float32 on `device`: one ray through each pixel's centre
    from the recipe's camera, pixels in Morton order."""
    view_inv, proj_inv = (m.astype(np.float64) for m in camera_matrices(rec))
    W, H = rec.width, rec.height
    pix = ref.morton_order(W, H)
    x = ((pix % W) + 0.5) / W * 2.0 - 1.0
    y = 1.0 - ((pix // W) + 0.5) / H * 2.0
    ndc = np.stack([x, y, np.zeros_like(x), np.ones_like(x)], -1)
    pv = ndc @ proj_inv.T
    d = (pv[:, :3] / np.abs(pv[:, 3:4])) @ view_inv[:3, :3].T
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(np.asarray(rec.camera["pos"], np.float32), d.shape)
    return (torch.as_tensor(np.ascontiguousarray(o), device=device),
            torch.as_tensor(d.astype(np.float32), device=device))


def image_numbers(errs, tol: float) -> dict:
    """compare.judge over the pixels' differences taken in float64, so
    that its split at `tol` is the harness's comparison with the limit: a
    float32 difference equal to float32(tol) lies above tol itself."""
    return compare.judge([e.double() for e in errs], tol)


def hit_numbers(got, want) -> dict:
    """The geometry part's numbers from two sides' hit distances of the
    same rays (+inf on a miss)."""
    got, want = got.double().cpu(), want.double().cpu()
    hg, hw = torch.isfinite(got), torch.isfinite(want)
    both = hg & hw
    rel = torch.where(both, (got - want).abs() / want.abs().clamp(min=1e-12),
                      0.0)
    bad = (hg != hw) | (both & ~(rel <= T_TOL))
    pad = (-bad.numel()) % TILE
    tiles = torch.cat([bad, bad.new_zeros(pad)]).reshape(-1, TILE)
    ok = rel[both & ~bad]
    return {HIT_SHARE: float(bad.double().mean()),
            HIT_TILE: float(tiles.sum(1).max()),
            HIT_AGREE: float(ok.max()) if ok.numel() else 0.0}


class Entry:
    unit = "camera samples"

    def __init__(self, scene, recipe, traffic: dict, seed: int, device):
        from hydracore_tpu_torch.integrators import bdpt

        self.bdpt, self.scene, self.seed, self.device = bdpt, scene, seed, \
            device
        self.recipe = recipe
        self.depth = traffic.get("max_depth", recipe.depth)
        self.strategies = traffic["strategies"]
        self.units_per_step = recipe.width * recipe.height
        c = traffic["check"]
        g = np.random.default_rng([seed & 0xFFFFFFFF, 0x1B97])
        self.early = set(g.permutation(c["early"])[:c["passes"] - 1].tolist())
        self.kept = {}
        self.last = None
        self.rays = self.hits = None

    def _render(self, pass_idx: int):
        return self.bdpt.bdpt_pass(self.scene, pass_idx, self.seed,
                                   max_depth=self.depth,
                                   strategies=self.strategies,
                                   device=self.device)

    def warm(self):
        self._render(WARM_PASS)

    def step(self, i: int):
        return self._render(i)

    def record(self, i: int, out) -> None:
        if i in self.early:
            self.kept[i] = out
        self.last = (i, out)

    def trace_targets(self):
        return [(self.bdpt, "closest_hit", "closest"),
                (self.bdpt, "closest_hit_sorted", "closest"),
                (self.bdpt, "any_hit_sorted", "any")]

    def release(self) -> None:
        """Casts the pixel-centre rays through the port's traversal API
        (whatever route the scene takes) for the geometry part of the
        check, then lets the port's scene go."""
        from hydracore_tpu_torch.ops import trace_api

        self.rays = centre_rays(self.recipe, self.device)
        self.hits = trace_api.closest_hit(self.scene, *self.rays)[0]
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
            want = ref.ibpt_pass(S, p, seed, self.depth)
            out = got[p] if C is None else ref.ibpt_pass(C, p, seed,
                                                         self.depth)
            errs.append(compare.errors(out, want, lit_only=True))
        o, d = self.rays
        every = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
        want = S.cast.closest(o, d, every)[0]
        hits = self.hits if C is None else C.cast.closest(
            o.to(C.dtype), d.to(C.dtype), every)[0]
        return {**image_numbers(errs, tol), **hit_numbers(hits, want)}
