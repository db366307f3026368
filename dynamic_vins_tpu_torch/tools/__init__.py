"""Offline tooling, counterpart of the JAX package's `tools/`:
`train_shipped_weights.py` retrains the shipped checkpoints of the
online nets with the port's trainer, and `precompute.py` runs the nets
over an image directory and writes the perception artifacts in the
reference's file formats (its `scripts/python/*_kitti.py` role).
"""
