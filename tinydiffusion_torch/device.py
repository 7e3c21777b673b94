"""Where the port's entry points run: the CUDA card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it asks for an absent card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was asked for and none is available; pass device='cpu' "
            "to run on the CPU"
        )
    return dev


def disable_tf32() -> None:
    """Run float32 convolutions and matmuls in full float32 on the card.

    PyTorch lets cuDNN convolve float32 in TF32 by default, which keeps only
    ~3 decimal digits. These are process-wide backend flags.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
