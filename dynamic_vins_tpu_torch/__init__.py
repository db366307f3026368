"""PyTorch/CUDA port of the dynamic VIO engine (Hopper target).

Module names follow the JAX reference package so each counterpart is
easy to find. This package imports torch, numpy and scipy only: it never
imports jax nor the JAX package, and keeps its own copies of the host
helpers it needs.

Entry points (`system.System`, `estimator.estimator.Estimator`,
`frontend.tracker.FeatureTracker`) run on the CUDA device unless the
caller passes `device="cpu"`; without a card and without that request
they raise.
"""
