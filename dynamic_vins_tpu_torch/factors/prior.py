"""Marginalization prior factor: r(x) = r0 + J0 (x ⊟ x0).

J0 spans the full camera-side tangent (columns of states the prior does
not constrain are zero), so a window slide is a column permutation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamic_vins_tpu_torch.solver import layout


class MarginalPrior(NamedTuple):
    lin_state: layout.WindowState   # linearization point x0
    jacobian: torch.Tensor          # [R, Dc]
    residual: torch.Tensor          # [R]
    valid: torch.Tensor             # [] bool — whether a prior exists

    @classmethod
    def empty(cls, num_frames: int = layout.NUM_FRAMES,
              dtype=torch.float64, device=None):
        D = layout.cam_dim(num_frames)
        return cls(layout.WindowState.identity(num_frames, dtype, device),
                   torch.zeros((D, D), dtype=dtype, device=device),
                   torch.zeros((D,), dtype=dtype, device=device),
                   torch.zeros((), dtype=torch.bool, device=device))


def residual_only(state: layout.WindowState, prior: MarginalPrior):
    dx = state.boxminus(prior.lin_state)
    r = prior.residual + prior.jacobian @ dx
    return torch.where(prior.valid, r, 0.0)


def evaluate(state: layout.WindowState, prior: MarginalPrior):
    """Residual [R] and (constant) Jacobian [R, Dc]."""
    J = torch.where(prior.valid, prior.jacobian, 0.0)
    return residual_only(state, prior), J
