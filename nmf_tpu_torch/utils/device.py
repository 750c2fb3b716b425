"""Device selection for the port.

A request for CUDA on a machine without a usable card raises: the port never
moves work to the CPU behind the caller's back.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The ``torch.device`` for ``device`` (``None`` means ``"cuda"``).

    For a CUDA device this also pins the f32 GEMM rules the port's plain
    path relies on: true IEEE f32, never TF32 (``allow_tf32 = False``,
    ``float32_matmul_precision = "highest"``; both are PyTorch's defaults,
    set here so that no earlier caller's choice leaks into a solve).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False (no usable NVIDIA card); pass device='cpu' for the "
                "plain CPU path"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev
