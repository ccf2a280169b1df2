"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is "cuda", and asking for CUDA on a machine without it raises
instead of carrying on silently on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return dev


def tree_to(obj, device):
    """Move a dataclass of tensors (nested dataclasses included) to
    `device`; numpy arrays become tensors on the way, other fields stay."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (np.ndarray, np.generic)):
        return torch.tensor(np.asarray(obj)).to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj
