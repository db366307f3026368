"""How far two results of one steady-state step on the same inputs part
(a graph replay against the eager step, on the card).

Positions and masks are compared as they are. The prior is compared by
the information it carries, J0ᵀJ0 and J0ᵀr0: its square root comes from
an eigendecomposition, whose eigenvectors may turn within a cluster of
near-equal eigenvalues when the inputs move in the last bits (the
card's `index_add_` sums in a run-dependent order).
"""

from __future__ import annotations

import torch

from dynamic_vins_tpu_torch.estimator.estimator import PipeState, StepConsts
from dynamic_vins_tpu_torch.solver import layout


def _info(prior):
    J = prior.jacobian
    return J.T @ J, J.T @ prior.residual


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def agreement(c: StepConsts, a, b):
    """a, b: two outputs of `megastep` or of `megastep_pipelined`. Returns
    {"pos_m": largest position difference of the solved window (m),
    "masks_equal": every mask the step returns agrees,
    "prior_rel": largest relative difference of J0ᵀJ0 and J0ᵀr0,
    "orth": largest difference of the solved line orth (LinePoint; 0
    without lines)}."""
    pipelined = isinstance(a[0], PipeState)
    ol = (c.pipe_layouts() if pipelined else c.mega_layouts())[2]
    oa, ob = a[-1], b[-1]
    masks = [(ol.get(oa, n), ol.get(ob, n))
             for n in ("new_tri", "bad", "re_ok", "dv", "l_alive")
             if n in ol.off]
    if pipelined:
        ra, rb = a[0], b[0]
        masks += [(ra.dv, rb.dv), (ra.alive, rb.alive),
                  (ra.obs[4], rb.obs[4]), (ra.obs[5], rb.obs[5])]
        pa, pb = ra.prior, rb.prior
    else:
        pa, pb = a[1], b[1]
    pos = lambda o: layout.WindowState.unpack(ol.get(o, "flat"),
                                              c.num_frames).p
    orth = float((ol.get(oa, "orth") - ol.get(ob, "orth")).abs().max()) \
        if "orth" in ol.off else 0.0
    return {"pos_m": float((pos(oa) - pos(ob)).abs().max()), "orth": orth,
            "masks_equal": all(torch.equal(x, y) for x, y in masks),
            "prior_rel": max(_rel(x, y)
                             for x, y in zip(_info(pa), _info(pb)))}
