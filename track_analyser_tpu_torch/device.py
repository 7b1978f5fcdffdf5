"""Device selection and the port's numerics policy, in one place.

Every tensor op of the port computes in full float32, like the JAX
reference on the CPU. On a CUDA device two PyTorch defaults would break
that: cuDNN runs float32 convolutions (the downbeat TCN) in TF32, which
keeps about three decimal digits, and a matmul may be allowed TF32 too.
``resolve_device`` turns both off explicitly before any work is placed
on the card.

A CUDA device that is not there raises: the port never falls back to
the CPU behind the caller's back.

``check_nans`` is the port's ``TRACK_ANALYSER_TPU_DEBUG_NANS=1``
sanitizer (the JAX package's ``jax_debug_nans``): every device graph
hands it its outputs, and with the variable set it raises
``FloatingPointError`` at the first NaN, naming the graph and the
output. The variable is read on each call; unset, the check costs one
environment lookup and no device sync.
"""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device", "check_nans", "DEBUG_NANS"]

DEBUG_NANS = "TRACK_ANALYSER_TPU_DEBUG_NANS"


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


def check_nans(graph: str, outputs):
    """``outputs`` (a tensor, or a tuple, list or dict of them) unchanged.
    With ``TRACK_ANALYSER_TPU_DEBUG_NANS=1`` raises ``FloatingPointError``
    naming ``graph`` and the output at the first NaN in a floating-point
    output (NaN only, as ``jax_debug_nans``: an infinity passes)."""

    if os.environ.get(DEBUG_NANS) != "1":
        return outputs
    if isinstance(outputs, torch.Tensor):
        named = [("output", outputs)]
    elif isinstance(outputs, dict):
        named = [(f"output {k!r}", v) for k, v in outputs.items()]
    else:
        named = [(f"output {i}", v) for i, v in enumerate(outputs)]
    for name, value in named:
        if isinstance(value, torch.Tensor) and value.is_floating_point() and bool(torch.isnan(value).any()):
            raise FloatingPointError(f"{DEBUG_NANS}=1: NaN in {name} of the device graph {graph}")
    return outputs
