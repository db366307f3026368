"""Train state, train step and checkpoints of the perception nets,
counterpart of the JAX package's `training/trainer.py`.

`OptaxAdamW` is `make_optimizer`'s optax chain written out op for op:
`clip_by_global_norm`, then `adamw` (Adam moments with bias
correction, decoupled weight decay on every leaf, biases and GroupNorm
scales included) scaled by `warmup_cosine_decay_schedule`, evaluated at
the step count before it increments (so the first update uses
0.1 * lr). The global-norm clip scales by `max_norm / norm` only when
the norm reaches `max_norm` (`clip_grad_norm_` divides by `norm + 1e-6`
always). The backward pass is autograd over the port's `nn.Module`s, the
counterpart of `jax.value_and_grad` over flax.

Checkpoints are the JAX package's `.npz` (`convert.to_flax` /
`convert.flax_params`, `solov2.save_params`' keys): a file either
package writes loads in the other. They hold the parameters only, as in
JAX. The JAX trainer's data-parallel mesh has a single-device
counterpart here; more than one device raises (ROADMAP queue 1 item
18).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from dynamic_vins_tpu_torch import convert
from dynamic_vins_tpu_torch.utils.precision import resolve_device


class TrainConfig(NamedTuple):
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    warmup_steps: int = 20
    total_steps: int = 1000
    min_lr_frac: float = 0.05


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float):
    """`optax.warmup_cosine_decay_schedule` (exponent 1) as a host
    function of the step count, with optax's types: its count is int32,
    so the linear warmup computes in float32; the cosine part computes
    in the default float type (float64 with JAX's x64, as here) and the
    join rounds it to float32."""
    f = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def linear(count):          # 0 <= count < warmup_steps
        frac = f(1) - f(count) / f(warmup_steps)
        return f(init_value - peak_value) * frac + f(peak_value)

    def cosine(count):
        c = min(float(count), float(cos_steps))
        decay = 0.5 * (1 + math.cos(math.pi * c / cos_steps))
        return f(peak_value * ((1 - alpha) * decay + alpha))

    return lambda count: linear(count) if count < warmup_steps \
        else cosine(count - warmup_steps)


class OptaxAdamW:
    """`optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
    weight_decay=...))` over a list of parameters, updated in place."""

    def __init__(self, params: Sequence[torch.Tensor], cfg: TrainConfig,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.cfg = cfg
        self.b1, self.b2, self.eps = b1, b2, eps
        self.schedule = warmup_cosine_decay(
            cfg.learning_rate * 0.1, cfg.learning_rate, cfg.warmup_steps,
            max(cfg.total_steps, cfg.warmup_steps + 1),
            cfg.learning_rate * cfg.min_lr_frac)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def _clip(self, grads):
        """(t / norm) * max_norm where norm >= max_norm, else t: both
        branches as device scalars (no host sync), t / 1 * 1 exact."""
        norm = torch.sqrt(sum(torch.sum(s) for s in
                              torch._foreach_mul(grads, grads)))
        keep = norm < self.cfg.grad_clip
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        out = torch._foreach_div(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(out, torch.where(
            keep, one, torch.full_like(one, self.cfg.grad_clip)))
        return out

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]):
        grads = self._clip(list(grads))
        b1, b2 = self.b1, self.b2
        # moments: (1 - b) * g^k + b * m, as optax.tree.update_moment
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        step_size = -self.schedule(self.count)
        self.count += 1
        # bias corrections in float64, cast to the parameters' type
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        # add_decayed_weights, then scale_by_learning_rate
        torch._foreach_add_(upd, torch._foreach_mul(
            self.params, self.cfg.weight_decay))
        torch._foreach_mul_(upd, float(step_size))
        torch._foreach_add_(self.params, upd)


def make_optimizer(params, cfg: TrainConfig) -> OptaxAdamW:
    return OptaxAdamW(params, cfg)


class DeviceMesh(NamedTuple):
    """A 1-D data mesh: the devices the batch is split over."""

    devices: tuple


def data_parallel_mesh(n_devices: int | None = None,
                       device=None) -> DeviceMesh:
    """The data mesh over the first n devices (all visible ones by
    default). One device runs the single-device step, which is what the
    JAX package's one-device mesh computes; more raise."""
    dev = resolve_device(device)
    n = n_devices or (torch.cuda.device_count() if dev.type == "cuda"
                      else 1)
    if n > 1:
        raise NotImplementedError(
            "data-parallel training over more than one device is not "
            "ported yet: ROADMAP queue 1 item 18")
    return DeviceMesh((dev,))


def to_device(batch, device):
    """numpy leaves of a batch (tuples, lists, dicts) -> tensors."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(v, device) for v in batch)
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(batch)).to(device)
    return batch


class Trainer:
    """Generic trainer: loss_fn(model, batch) -> (loss, aux), the batch's
    numpy leaves placed on the model's device as tensors."""

    def __init__(self, loss_fn: Callable[[Any, Any], tuple],
                 model: torch.nn.Module, cfg: TrainConfig = TrainConfig(),
                 device=None, mesh: DeviceMesh | None = None):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None \
            else resolve_device(device)
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        self.tx = make_optimizer(self.params, cfg)
        self.step_count = 0

    def place_batch(self, batch):
        return to_device(batch, self.device)

    def step(self, batch):
        """One optimizer step; returns (loss, aux) as host floats."""
        batch = self.place_batch(batch)
        loss, aux = self.loss_fn(self.model, batch)
        # a parameter the loss does not reach (FCOS3D's P2 branch) gets
        # a zero gradient, as under jax.grad: Adam and the decay still
        # move it
        grads = torch.autograd.grad(loss, self.params, allow_unused=True,
                                    materialize_grads=True)
        self.tx.step(grads)
        self.step_count += 1
        return float(loss.detach()), {k: float(v.detach())
                                      for k, v in aux.items()}

    # ------------------------------------------------------------------
    def save(self, path: str):
        """Checkpoint params (the JAX package's `save_params` layout)."""
        np.savez(path, **convert.to_flax(self.model))

    def load(self, path: str):
        """Params from a checkpoint of either package; the optimizer
        state stays (as the JAX trainer's does)."""
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        self.model.load_state_dict(convert.flax_params(flat, self.model))
