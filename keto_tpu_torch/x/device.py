"""Device selection for every entry point of the port.

The engine, the server and the CLI run on ``cuda`` unless the caller asks
for the CPU by name. With no CUDA device and no explicit ``"cpu"`` they
raise: the port never carries on quietly on the host, because a CPU run
would hide a kernel that does not build or launch.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` → the CPU; anything else as given.
    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    return dev


def same_device(a: Union[str, torch.device], b: Union[str, torch.device]) -> bool:
    """Do ``a`` and ``b`` name the same device (``cuda`` is ``cuda:0``)?"""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.type == "cpu" or (a.index or 0) == (b.index or 0))
