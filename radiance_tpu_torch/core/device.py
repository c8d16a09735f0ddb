"""Where the port's tensors go when the caller does not say.

Entry points that make tensors (scene tables, bindings, camera) default
to the card: device="cuda".  Without a card that default raises; the
CPU is used only when the caller asks for it (device="cpu"), as the
tests do.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """torch.device(device), raising a clear error for a CUDA device on
    a machine without one.  A bare "cuda" is pinned to the current card,
    so that "cuda" and "cuda:0" name (and key caches by) one device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "radiance_tpu_torch runs on the CUDA card by default, and "
                "torch.cuda.is_available() is False here: pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
