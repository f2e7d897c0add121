"""Device selection: the card by default, the CPU only when asked for."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent.

    There is no silent CPU fallback: a caller that wants the CPU (the
    tests) says device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
