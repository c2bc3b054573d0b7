"""Device and dtype resolution for the port's entry points.

The port serves on the card.  The CPU is a place the caller has to ask for
(``device="cpu"``, as the tests do); a missing card is an error, never a
silent fallback.  Nothing here runs at import time.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is visible); ``"cpu"``
    only when asked for; any other device type raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev!s}: use cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` -> the torch dtype."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {name!r}; one of {sorted(DTYPES)}") from None
