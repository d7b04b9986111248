"""The device a solve runs on."""

import torch


def resolve_device(device=None) -> torch.device:
    """The device a solve runs on: CUDA unless the caller names another.
    With no CUDA device and no explicit choice this raises; it never
    drops to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cuclarabel_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to solve on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def shard_devices(n_devices: int, device=None) -> list:
    """The ordered devices of an n_devices-way split: on the CPU every
    shard is the CPU; on CUDA the cards from resolve_device(device) on
    (cuda:0, cuda:1, ... by default).  Asking for more cards than the
    host has raises ValueError; the count is never shrunk."""
    n_devices = int(n_devices)
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    first = resolve_device(device)
    if first.type != "cuda":
        return [first] * n_devices
    start = first.index if first.index is not None else 0
    have = torch.cuda.device_count()
    if start + n_devices > have:
        raise ValueError(
            f"n_devices={n_devices} from cuda:{start} needs "
            f"{start + n_devices} CUDA devices; this host has {have}")
    return [torch.device("cuda", start + i) for i in range(n_devices)]
