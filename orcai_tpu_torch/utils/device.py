"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on; never falls back.

    "cuda" (the default of every entry point) raises when PyTorch sees no
    CUDA device instead of quietly running on the CPU; the CPU runs only
    when the caller passes device="cpu".
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def exact_f32_math():
    """Within the block, keep float32 matmuls and cuDNN convolutions in IEEE
    float32; the process's earlier TF32 settings come back on exit.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits), which cannot hold the 2e-5 parity bar of the f32 CRNN. The
    flags are read when a kernel is chosen, on the host, so the block needs
    to cover the launches only, not their completion.
    """
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
