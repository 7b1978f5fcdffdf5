"""Device selection and the port's numerics policy, in one place.

Every tensor op of the port computes in full float32, like the JAX
reference on the CPU. On a CUDA device two PyTorch defaults would break
that: cuDNN runs float32 convolutions (the downbeat TCN) in TF32, which
keeps about three decimal digits, and a matmul may be allowed TF32 too.
``resolve_device`` turns both off explicitly before any work is placed
on the card.

A CUDA device that is not there raises: the port never falls back to
the CPU behind the caller's back.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: "str | torch.device") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and
    CUDA is absent. For CUDA, sets full-float32 matmuls and convolutions
    (TF32 off)."""

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
