"""The numbers a check compares, each worked out from the program's output
and the plain reference's."""

from __future__ import annotations

import math

import torch


def table_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference of two tables of the same rows, as a
    share of the reference table's largest entry (NaN or a shape that
    differs reads as infinite)."""
    if got.shape != want.shape:
        return math.inf
    got, want = got.float(), want.float()
    scale = float(want.abs().max()) if want.numel() else 1.0
    diff = (got - want).abs()
    if not bool(torch.isfinite(diff).all()):
        return math.inf
    return float(diff.max()) / max(scale, 1e-30) if diff.numel() else 0.0
