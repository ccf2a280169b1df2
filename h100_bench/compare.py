"""How the port's outputs are judged against the reference's: per pixel,
the summed absolute difference over the channels relative to the
reference's summed magnitude (with a floor for dark pixels). A pixel
whose relative difference passes the cell's per-pixel tolerance (its
limit of AGREE in limits/<cell>.json) is a mismatch; the number compared
is the share of mismatched pixels, beside the largest relative
difference of the pixels that agree."""
from __future__ import annotations

import torch

FLOOR = 1e-3
SHARE = "pixel_mismatch_share"
AGREE = "pixel_rel_err_agreeing_max"
MEDIAN = "pixel_rel_err_median"


def relative_error(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(N,) relative differences of (N, 3) colours (NaN reads as 1)."""
    prog = prog.float().reshape(-1, 3)
    ref = ref.float().reshape(-1, 3)
    err = (prog - ref).abs().sum(-1) / (ref.abs().sum(-1) + FLOOR)
    return torch.nan_to_num(err, nan=1.0, posinf=1.0)


def errors(prog, ref, lit_only: bool = False) -> torch.Tensor:
    """The pixels' relative differences; with lit_only only of pixels
    that either side lit."""
    err = relative_error(prog, ref)
    if lit_only:
        lit = (prog.float().reshape(-1, 3).abs().sum(-1)
               + ref.float().reshape(-1, 3).abs().sum(-1)) > 0
        err = err[lit]
    return err


def judge(errs: list, tol: float) -> dict:
    """The numbers of the check from every compared pixel's relative
    difference: the mismatched share (difference over `tol`), the largest
    difference among the others, and the median (for the record)."""
    e = torch.cat([x.flatten().cpu() for x in errs]) if errs else \
        torch.zeros(0)
    if e.numel() == 0:
        return {SHARE: 1.0, AGREE: 0.0, MEDIAN: float("nan")}
    ok = e[e <= tol]
    return {SHARE: float((e > tol).sum()) / e.numel(),
            AGREE: float(ok.max()) if ok.numel() else 0.0,
            MEDIAN: float(e.median())}
