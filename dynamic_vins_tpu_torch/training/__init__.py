"""Training of the online perception nets, counterpart of the JAX
package's `training/`: each net family gets a supervised loss, a
synthetic data source with exact labels and a train step, so the nets
train on the card (or the CPU) without external datasets.

  losses.py  - per-family losses and target builders (stereo / flow /
               SOLOv2 / FCOS3D / ReID)
  data.py    - synthetic labeled batch generators (exact ground truth)
  trainer.py - the optax-equal AdamW, the train step, checkpoints in
               the JAX package's `.npz` layout
  cli.py     - `python -m dynamic_vins_tpu_torch.training.cli`
"""

from dynamic_vins_tpu_torch.training.trainer import (Trainer, TrainConfig,
                                                     data_parallel_mesh)

__all__ = ["Trainer", "TrainConfig", "data_parallel_mesh"]
