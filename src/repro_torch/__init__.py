"""PyTorch + CUDA port of the streaming LM serving path of ``repro``.

The package mirrors the JAX package's module names (``models/common.py``,
``models/blocks.py``, ``models/lm.py``, ``kernels/ops.py``,
``runtime/server.py``) so each piece has an obvious counterpart there, and
imports nothing of it: what it needs (the configs) it keeps as a copy.

Its entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise instead of quietly running on the CPU.

Float32 matrix products run in full float32 on the card: TF32 is switched
off for cuBLAS and cuDNN here, where the package is set up, so that a
float32 run holds to the float32 reference.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
