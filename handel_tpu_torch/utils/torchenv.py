"""Device choice for the PyTorch port — counterpart of handel_tpu/utils/jaxenv.py.

Every entry point of the port takes a `device` argument. The default is the
card (`cuda`); the CPU is used only when the caller names it, as the tests
do. Asking for `cuda` where there is none raises: the port never slips onto
the CPU behind the caller's back, because a number measured there would be
read as a device number.

The sim's processes take no argument for it: they read `HANDEL_TORCH_DEVICE`
(`cuda` or `cpu`; unset means `cuda`) through `device_from_env`, the
counterpart of the reference's `HANDEL_TPU_PLATFORM`.
"""

from __future__ import annotations

import os

import torch

DEFAULT_DEVICE = "cuda"
DEVICE_ENV = "HANDEL_TORCH_DEVICE"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch.device an entry point runs on: `device`, else `cuda`.

    Raises RuntimeError for a CUDA device on a machine without one, and
    ValueError for device types the port has no path for."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}: 'cuda' or 'cpu'")
    return dev


def device_from_env() -> torch.device:
    """The device named by $HANDEL_TORCH_DEVICE, else `cuda`, through
    `resolve_device`: unset on a host without a card, it raises."""
    return resolve_device(os.environ.get(DEVICE_ENV) or None)


def device_type_from_env() -> str:
    """`cuda` or `cpu`, as $HANDEL_TORCH_DEVICE names it, checked as
    `device_from_env` checks it but without creating a CUDA context: for a
    process that only starts the card's users (the sim's platforms, `sim
    watch`), which must not hold a context of its own beside theirs."""
    dev = torch.device(os.environ.get(DEVICE_ENV) or DEFAULT_DEVICE)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; set {DEVICE_ENV}=cpu to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {dev.type!r}: 'cuda' or 'cpu'")
    return dev.type
