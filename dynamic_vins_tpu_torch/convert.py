"""Carry parameters from the JAX package's types into the port's.

Parity tests start both packages from identical state. The JAX side
hands its NamedTuples over as numpy arrays keyed by field name (nested
dicts for nested tuples, e.g. `{"lin_state": {...}, "jacobian": ...}`);
these functions return the port's types on a given device and dtype.
A whole estimator's state crosses as a checkpoint instead:
`Estimator.save_checkpoint` / `load_checkpoint` write and read the JAX
package's `.npz` keys, in either direction. A net's parameters cross
both ways too: `flax_params` (flattened flax -> state dict) and
`to_flax` (module -> flattened flax, `solov2.save_params`' keys). This
module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamic_vins_tpu_torch.factors.line_factor import LineObs
from dynamic_vins_tpu_torch.factors.object_factors import ObjectWindow
from dynamic_vins_tpu_torch.factors.prior import MarginalPrior
from dynamic_vins_tpu_torch.factors.projection import ProjObs
from dynamic_vins_tpu_torch.geometry.camera import PinholeIntrinsics
from dynamic_vins_tpu_torch.imu.preintegration import (ImuNoise,
                                                       Preintegration)
from dynamic_vins_tpu_torch.solver.gauss_newton import BAProblem
from dynamic_vins_tpu_torch.solver.layout import WindowState
from dynamic_vins_tpu_torch.solver.object_solver import ObjectProblem


def _f(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _x(a, device):
    """Integer/bool arrays keep their kind (indices become int64)."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def _floats(cls, d, dtype, device):
    return cls(*(_f(d[k], dtype, device) for k in cls._fields))


def intrinsics(d, dtype=torch.float64, device="cpu") -> PinholeIntrinsics:
    return _floats(PinholeIntrinsics, d, dtype, device)


def extrinsics(p_bc, q_bc, dtype=torch.float64, device="cpu"):
    """(p_bc [2,3], q_bc [2,4]) camera-to-body transforms."""
    return _f(p_bc, dtype, device), _f(q_bc, dtype, device)


def imu_noise(d) -> ImuNoise:
    return ImuNoise(*(float(d[k]) for k in ImuNoise._fields))


def window_state(d, dtype=torch.float64, device="cpu") -> WindowState:
    return _floats(WindowState, d, dtype, device)


def preintegration(d, dtype=torch.float64, device="cpu"):
    return _floats(Preintegration, d, dtype, device)


def marginal_prior(d, dtype=torch.float64, device="cpu") -> MarginalPrior:
    return MarginalPrior(window_state(d["lin_state"], dtype, device),
                         _f(d["jacobian"], dtype, device),
                         _f(d["residual"], dtype, device),
                         _x(d["valid"], device))


def proj_obs(d, dtype=torch.float64, device="cpu") -> ProjObs:
    ints = ("frame_i", "frame_j", "cam_j", "lm", "valid")
    return ProjObs(*(_x(d[k], device) if k in ints
                     else _f(d[k], dtype, device)
                     for k in ProjObs._fields))


def line_obs(d, dtype=torch.float64, device="cpu") -> LineObs:
    return LineObs(*(_f(d[k], dtype, device) if k in ("s", "e")
                     else _x(d[k], device) for k in LineObs._fields))


def ba_problem(d, dtype=torch.float64, device="cpu") -> BAProblem:
    """A BA problem; its line table and line mask where `d` has them."""
    lines = isinstance(d.get("line_obs"), dict)
    return BAProblem(obs=proj_obs(d["obs"], dtype, device),
                     pres=preintegration(d["pres"], dtype, device),
                     imu_valid=_x(d["imu_valid"], device),
                     prior=marginal_prior(d["prior"], dtype, device),
                     lm_valid=_x(d["lm_valid"], device),
                     fixed_cols=_x(d["fixed_cols"], device),
                     line_obs=line_obs(d["line_obs"], dtype, device)
                     if lines else None,
                     line_valid=_x(d["line_valid"], device)
                     if lines else None)


def object_window(d, dtype=torch.float64, device="cpu") -> ObjectWindow:
    """An object window (one object, or a leading object axis)."""
    return _floats(ObjectWindow, d, dtype, device)


def object_problem(d, dtype=torch.float64, device="cpu") -> ObjectProblem:
    """An object problem: integer and bool fields keep their kind."""
    return ObjectProblem(*(_x(d[k], device)
                           if np.asarray(d[k]).dtype.kind in "iub"
                           else _f(d[k], dtype, device)
                           for k in ObjectProblem._fields))


# the host state of an InstanceManager, as numpy arrays
INSTANCE_STATE = ("active", "track_id", "cls", "age", "lost", "is_static",
                  "static_cnt", "initialized", "p", "q", "v", "w", "dims",
                  "c_off", "frame_valid", "lm", "lm_valid", "lm_feat_id",
                  "obs", "obs_valid", "extra", "extra_valid", "dims_det",
                  "dims_det_valid", "q_det", "det_valid", "gen")


def load_instance_state(im, d):
    """Set a port InstanceManager's host state from `d` (the
    INSTANCE_STATE arrays and `tid_to_slot`, {track id: slot}); no
    solve may be pending on either side."""
    if im._pending:
        raise ValueError("the instance manager has a pending solve")
    for name in INSTANCE_STATE:
        a = np.asarray(d[name])
        if a.shape != getattr(im, name).shape:
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"{getattr(im, name).shape}")
        setattr(im, name, a.astype(getattr(im, name).dtype, copy=True))
    im._tid_to_slot = {int(k): int(v) for k, v in d["tid_to_slot"].items()}


# flax leaf name -> torch parameter name (Conv / Dense kernels and
# GroupNorm scales are `weight`)
_FLAX_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _flax_key(key: str) -> str:
    """"('params')/('FPN_0')/('lat0')/('kernel')" (the `.npz` keys of
    the JAX package's `solov2.save_params`, `[`/`]` stored as `(`/`)`)
    -> "FPN_0.lat0.weight"."""
    parts = [p.strip("()[]'\"") for p in key.split("/")]
    if parts and parts[0] == "params":
        parts = parts[1:]
    return ".".join(parts[:-1] + [_FLAX_LEAF.get(parts[-1], parts[-1])])


def _flax_array(a: np.ndarray) -> torch.Tensor:
    """A flax leaf in torch's layout: Dense [in,out] -> [out,in], Conv
    HWIO -> OIHW, 3-D conv DHWIO -> OIDHW; float16 storage -> float32
    (the JAX package casts a loaded leaf to its template's float32)."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dim() >= 2:
        t = t.permute(*range(t.dim() - 1, t.dim() - 3, -1),
                      *range(t.dim() - 2))
    return t.contiguous()


def flax_params(flat, module: torch.nn.Module) -> dict:
    """A state dict for one of the port's nets (`models/`) from flattened
    flax parameters {path: array} (an `.npz` of the JAX package's
    `save_params`, or a flattened JAX parameter tree with the same
    keys). Submodules carry flax's names, so a path maps one to one. A
    parameter absent from `flat` keeps the module's own value (as
    `load_params` keeps its template's leaf); a shape that disagrees
    raises; keys the module does not have are ignored."""
    state = module.state_dict()
    for key, a in flat.items():
        name = _flax_key(key)
        if name not in state:
            continue
        t = _flax_array(a)
        if tuple(t.shape) != tuple(state[name].shape):
            raise ValueError(
                f"parameter {name}: the checkpoint holds shape "
                f"{tuple(t.shape)}, the module expects "
                f"{tuple(state[name].shape)}")
        state[name] = t.to(state[name].dtype)
    return state


def to_flax(module: torch.nn.Module) -> dict:
    """The flattened flax parameters {key: float32 array} of one of the
    port's nets, the inverse of `flax_params`: keys in the form of the
    JAX package's `solov2.save_params` ("('params')/('FPN_0')/('lat0')/
    ('kernel')"), a `weight` named `scale` on a GroupNorm and `kernel`
    elsewhere, Conv OIHW -> HWIO, 3-D conv OIDHW -> DHWIO, Dense
    [out,in] -> [in,out]. `np.savez(path, **to_flax(m))` writes a
    checkpoint the JAX package's `load_params` reads."""
    from dynamic_vins_tpu_torch.models.layers import GroupNorm

    out = {}
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            leaf = pname
            if pname == "weight":
                leaf = "scale" if isinstance(mod, GroupNorm) else "kernel"
            path = ["params"] + (mname.split(".") if mname else []) + [leaf]
            t = p.detach().to("cpu", torch.float32)
            if t.dim() >= 2:
                t = t.permute(*range(2, t.dim()), 1, 0)
            out["/".join(f"('{q}')" for q in path)] = \
                np.ascontiguousarray(t.numpy())
    return out
