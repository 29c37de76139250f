"""PyTorch/CUDA port of the KATANA tracking system.

The live tracking frame (``core.tracker.frame_step`` /
``imm_frame_step`` behind ``serving.engine.TrackingEngine.submit``) runs
on an NVIDIA H100 through hand-written CUDA kernels
(``kernels/katana_bank/csrc``). Every entry point takes an explicit
``device``: it defaults to ``"cuda"`` and raises when no card is
present; pass ``device="cpu"`` to run the kernels' plain PyTorch
versions instead.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) must
    name a present card: without one this raises instead of quietly
    running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
