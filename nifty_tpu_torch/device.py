"""Where the port's entry points put what they build: on the card.

An entry point that makes tensors (``CorrelatedFieldMaker.finalize``,
``position_from_numpy``, ``Initializer``, ``random_like``, a likelihood
given numpy data) takes ``device=None`` to mean the CUDA card.  Without a
card that raises; running on the CPU takes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve"]


def resolve(device=None) -> torch.device:
    """``torch.device(device)``, or the CUDA card when ``device`` is None
    (raises when there is none)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card unless "
            "given device='cpu'"
        )
    return torch.device("cuda")
