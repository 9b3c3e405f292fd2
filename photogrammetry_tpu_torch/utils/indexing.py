"""Row access by an index that may live on the device.

``x[i]`` with a 0-dim integer tensor ``i`` reads ``i`` back to the host (it
becomes an integer select), which a CUDA-graph capture cannot do.  These
helpers take a Python int or a 0-dim integer tensor: the int as a plain
select, the tensor gathered and scattered on the device.  Both forms give
the same values.
"""
from __future__ import annotations

import torch


def take_row(x: torch.Tensor, i) -> torch.Tensor:
    """``x[i]`` along the first axis."""
    if isinstance(i, torch.Tensor):
        return x.index_select(0, i.reshape(1).long()).squeeze(0)
    return x[i]


def put_row(x: torch.Tensor, i, v: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with row ``i`` replaced by ``v`` (``x.at[i].set(v)``);
    ``v`` has the row's shape and ``x``'s dtype."""
    if isinstance(i, torch.Tensor):
        return x.index_copy(0, i.reshape(1).long(), v.unsqueeze(0))
    y = x.clone()
    y[i] = v
    return y
