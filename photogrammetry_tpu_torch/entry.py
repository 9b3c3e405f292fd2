"""The flagship forward step on the port: two grayscale frames → relative
pose + triangulated structure (the counterpart of the JAX package's
``__graft_entry__.entry`` forward): detect and describe each frame, match
the pair, then the two-view pipeline.

    from photogrammetry_tpu_torch.entry import ENTRY_CONFIG, ENTRY_K, forward
    from photogrammetry_tpu_torch.sfm.frontend import make_pairs
    out = forward(im1, im2, make_pairs(ENTRY_CONFIG), ENTRY_K)  # on CUDA
    out.two_view.r, out.two_view.t
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from photogrammetry_tpu_torch import resolve_device
from photogrammetry_tpu_torch.sfm.frontend import (
    DescribedFrame, FrontendConfig, MatchedPair, detect_and_describe,
    match_pair,
)
from photogrammetry_tpu_torch.sfm.two_view import (
    TwoViewResult, two_view_pipeline,
)

# the configuration and intrinsics of __graft_entry__.entry
ENTRY_CONFIG = FrontendConfig(detection_threshold=20.0, max_keypoints=256,
                              reduction="nms", suppression_radius=4.0,
                              hamming_threshold=80)
ENTRY_K = np.array([[520.0, 0.0, 320.0], [0.0, 520.0, 240.0],
                    [0.0, 0.0, 1.0]], np.float32)


class EntryResult(NamedTuple):
    frame1: DescribedFrame
    frame2: DescribedFrame
    match: MatchedPair
    two_view: TwoViewResult


def _on(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=dtype).contiguous()


def forward(im1, im2, pairs, k, config: FrontendConfig = ENTRY_CONFIG, *,
            generator: torch.Generator | None = None, device="cuda",
            threshold: float = 1.5, num_samples: int = 256,
            h_samples: int = 500, model: str = "auto",
            plain: bool = False) -> EntryResult:
    """Run the forward step on ``device`` (default CUDA; raises without a
    card unless ``device='cpu'``).

    im1, im2: (H, W) grayscale frames (numpy or tensors); pairs: (P, 2, 2)
    BRIEF offsets; k: (3, 3) intrinsics.  ``generator`` draws the RANSAC
    samples (a generator on ``device`` seeded with 0 when None).
    ``plain=True`` runs the kernels' plain PyTorch versions instead of the
    kernels, for holding one against the other on the card.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    im1 = _on(im1, dev, torch.float32)
    im2 = _on(im2, dev, torch.float32)
    pairs = _on(pairs, dev, torch.int32)
    k = _on(k, dev, torch.float32)
    f1 = detect_and_describe(im1, pairs, config, plain=plain)
    f2 = detect_and_describe(im2, pairs, config, plain=plain)
    m = match_pair(f1, f2, config, plain=plain)
    tv = two_view_pipeline(generator, m.xy1, m.xy2, m.mask, k,
                           threshold=threshold, num_samples=num_samples,
                           model=model, h_samples=h_samples)
    return EntryResult(frame1=f1, frame2=f2, match=m, two_view=tv)
