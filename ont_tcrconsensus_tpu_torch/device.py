"""Where the port runs: the CUDA card unless the caller asks for the CPU.

Every public entry point of the port takes ``device=None`` and passes it
through :func:`resolve_device`, so a library caller who names no device
runs on the card, and gets an error, not a silent CPU run, when there is
none.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """CUDA unless ``device`` names the CPU; a CUDA device without a card
    raises. Float32 matmuls and cuDNN (the polisher's GRUs) stay full
    float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the CPU is asked "
            "for (--cpu, or device='cpu')"
        )
    return dev
