"""Offline tooling, counterpart of the JAX package's `tools/`:
`train_shipped_weights.py` retrains the shipped checkpoints of the
online nets with the port's trainer; `precompute.py` runs the nets
over an image directory and writes the perception artifacts in the
reference's file formats (its `scripts/python/*_kitti.py` role);
`build_engines.py` exports the nets' online stages with `torch.export`
(the reference's TensorRT engine builders' role); and the bench-side
tools: `accuracy_probe.py` (the bench protocol's ATE at a chosen float
type and device), `dynamic_bench.py` (DYNAMIC ms/frame and errors) and
`singlechip_scaling.py` (the LM's time against the problem's size and
batched windows, and a reduction model for N cards). Each runs on the
card unless asked for the CPU.
"""
