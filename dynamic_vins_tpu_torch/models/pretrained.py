"""The shipped synthetic-trained checkpoints of the online nets.

The checkpoints are the JAX package's: `dynamic_vins_tpu/weights/
{solo,det3d,stereo,flow,reid}.npz` (flattened flax parameters, float16),
pinned by `MANIFEST.json` with the constructor hyperparameters each was
trained with. They are read where they lie, by file path from the
repository root, and converted by `convert.flax_params`; nothing of the
JAX package is imported. Image size, `max_disp` and `iters` are free
(the nets are fully convolutional, and RAFT's update shares its
parameters across iterations).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from dynamic_vins_tpu_torch import convert

WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "dynamic_vins_tpu" \
    / "weights"


def manifest() -> Dict[str, Any]:
    path = WEIGHTS_DIR / "MANIFEST.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)


def weights_path(task: str) -> Optional[str]:
    """Path of the shipped checkpoint for `task`, or None."""
    entry = manifest().get(task)
    if entry is None:
        return None
    path = WEIGHTS_DIR / entry["file"]
    return str(path) if path.exists() else None


def hyperparams(task: str) -> Dict[str, Any]:
    """Model-constructor kwargs the checkpoint was trained with."""
    return dict(manifest().get(task, {}).get("model", {}))


def prepare(model: torch.nn.Module, params_path: Optional[str], dtype,
            device) -> torch.nn.Module:
    """Load `params_path` (an `.npz` of flattened flax parameters) into
    `model` if given, cast it to `dtype`, move it to `device`, and set
    inference mode. A parameter missing from the file keeps the model's
    own; a shape that disagrees raises (as the JAX package's
    `load_params` + apply does, there at the first call)."""
    if params_path:
        with np.load(params_path) as data:
            flat = {k: data[k] for k in data.files}
        model.load_state_dict(convert.flax_params(flat, model))
    return model.to(device=device, dtype=dtype).eval()


def load_online(task: str, image_hw, intrinsics=None, device=None,
                **overrides):
    """The online wrapper of `task` ('solo' | 'det3d' | 'stereo' |
    'flow' | 'reid') with its shipped weights, or those of
    `params_path=` (a checkpoint of the same shapes, e.g. one that
    `tools.train_shipped_weights` wrote); the model-shape kwargs come
    from the manifest, extra kwargs override the wrapper's own."""
    path = overrides.pop("params_path", None) or weights_path(task)
    kw = {**hyperparams(task), **overrides}
    if task == "solo":
        from dynamic_vins_tpu_torch.models.solov2 import OnlineDetector2D

        return OnlineDetector2D(image_hw, params_path=path, device=device,
                                **kw)
    if task == "det3d":
        from dynamic_vins_tpu_torch.models.det3d import OnlineDetector3D

        if intrinsics is None:
            raise ValueError("det3d needs intrinsics (fx,fy,cx,cy)")
        return OnlineDetector3D(image_hw, intrinsics, params_path=path,
                                device=device, **kw)
    if task == "stereo":
        from dynamic_vins_tpu_torch.models.stereo_net import \
            OnlineStereoMatcher

        return OnlineStereoMatcher(image_hw, params_path=path,
                                   device=device, **kw)
    if task == "flow":
        from dynamic_vins_tpu_torch.models.raft import OnlineFlowEstimator

        return OnlineFlowEstimator(image_hw, params_path=path,
                                   device=device, **kw)
    if task == "reid":
        from dynamic_vins_tpu_torch.models.reid import ReidExtractor

        return ReidExtractor(params_path=path, device=device, **kw)
    raise ValueError(f"unknown task {task!r}")
