"""Reductions with the JAX package's semantics where torch's differ."""
from __future__ import annotations

import torch

from photogrammetry_tpu_torch.utils.indexing import take_row


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of ``x`` (flattened), as
    ``jnp.nanmedian`` computes it: the midpoint ``(lo + hi) * 0.5`` of the
    two middle values, so an even count averages them (``torch.nanmedian``
    returns the lower one); an all-NaN input gives NaN.  No host read (the middle values are
    gathered on the device)."""
    a = torch.sort(x.reshape(-1)).values          # NaNs sort last
    count = (~torch.isnan(a)).sum().to(a.dtype)
    q = 0.5 * (count - 1.0)
    top = torch.clamp(count - 1.0, min=0.0)
    lo = torch.clamp(torch.floor(q), min=0.0).minimum(top).to(torch.int64)
    hi = torch.clamp(torch.ceil(q), min=0.0).minimum(top).to(torch.int64)
    return (take_row(a, lo) + take_row(a, hi)) * 0.5
