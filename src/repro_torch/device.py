"""The package's default torch device.

Entry points run on the card unless the caller asks for the CPU: the
default is ``cuda``, and a constructor that allocates (`OffloadEngine`,
`ProtectionDomain`, a device-resident `Ring`) takes ``device=None`` to
mean this default. A default of ``cuda`` on a machine without a card
raises instead of quietly running on the CPU; tests select the CPU
explicitly with ``set_default("cpu")``.
"""
from __future__ import annotations

import torch

_DEFAULT = torch.device("cuda")


def set_default(device) -> torch.device:
    """Set the package default device; returns the previous one."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, torch.device(device)
    return prev


def get_default() -> torch.device:
    return _DEFAULT


def device_type(device=None) -> str:
    """The device type `device` (or the default) names, without checking
    that such a device exists — policy lookups key on it."""
    return (_DEFAULT if device is None else torch.device(device)).type


def resolve(device=None) -> torch.device:
    """`device`, or the package default, checked to exist: a CUDA device
    with no card present raises RuntimeError."""
    dev = _DEFAULT if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' (or set_default('cpu')) to "
                "run on the CPU")
        if dev.index is None:       # compare equal to tensor.device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
