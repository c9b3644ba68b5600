"""Hand-written Hopper kernels of the port and their plain versions."""
from __future__ import annotations

import torch

_workspaces: dict[tuple[torch.device, torch.dtype], torch.Tensor] = {}


def workspace(device: torch.device, n: int,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A scratch buffer of at least ``n`` elements of ``dtype`` on
    ``device``, kept for later calls of every kernel wrapper (it only
    grows), so a steady-state call allocates nothing.  The kernels run in
    stream order, so the calls of one stream may share it."""
    buf = _workspaces.get((device, dtype))
    if buf is None or buf.numel() < n:
        _workspaces.pop((device, dtype), None)
        buf = torch.empty(n, dtype=dtype, device=device)
        _workspaces[(device, dtype)] = buf
    return buf
