"""Device selection for the port's entry points.

``device=None`` means the CUDA card; with no CUDA present that raises.
The CPU runs only when the caller names it (``device="cpu"``), as the
tests do — then every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """The torch device an entry point runs on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def h2d(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device``.  To the card the copy goes through pinned
    memory, asynchronously on the current stream (the caching host
    allocator keeps the pinned block until the copy has run), so the host
    does not stall; on the CPU the tensor shares ``arr``'s memory."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t)
    return pinned.to(device, non_blocking=True)


def d2h(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array.  From the card: one copy into pinned host
    memory on the current stream, then one sync of that stream (no
    pageable staging copy); a CPU tensor's memory as it is."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()
