"""Device and dtype policy, with full-float32 matmuls on the card.

The estimator's float type follows the device where none is given:
float32 on the card, float64 on the CPU (`default_dtype`). The JAX
package gets the same split from its x64 flag: its float64 default is
canonicalized to float32 on an accelerator with x64 off, and the tests
turn x64 on for the CPU.

The JAX package traces its solver under float32 matmul precision
(`precise_jit`) because reduced-precision matmul inputs cost the
estimator accuracy. The CUDA counterpart of those reduced-precision passes is TF32, which
PyTorch may use for float32 matmuls and, by default, for cuDNN
convolutions. `resolve_device` turns both off, so every entry point
runs its float32 algebra in full float32:

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
"""

from __future__ import annotations

import torch


def set_full_float32():
    """Disable TF32 for matmuls and cuDNN (the precise_jit mirror)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise.

    Raises when CUDA is requested (explicitly or by default) and no card
    is present: a measurement or a run that silently lands on the CPU
    would report CPU numbers under device names.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the "
            "CPU")
    set_full_float32()
    return dev



def default_dtype(device) -> torch.dtype:
    """The estimator's float type on `device` when none is given:
    float32 on a CUDA device, float64 on the CPU."""
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64
