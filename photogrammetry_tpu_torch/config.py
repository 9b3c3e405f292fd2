"""Layered configuration system (port of photogrammetry_tpu/config.py).

Reference analogue: .NET appsettings.json + appsettings.{ENV}.json overlay
selected by PHOTOGRAMMETRY_ENVIRONMENT, bound to validated option classes
(Program.cs:28-36,61-69; Options/*.cs).  Here: dataclass configs over the
port's ``FrontendConfig``, a JSON file + environment overlay loader, and
fail-fast validation at load time.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional

from photogrammetry_tpu_torch.sfm.frontend import FrontendConfig

ENV_VAR = "PHOTOGRAMMETRY_ENVIRONMENT"


@dataclass(frozen=True)
class DeWarpConfig:
    """5-parameter rational radial model (DeWarpOptions.cs:5-11;
    appsettings.json defaults [3e-4, 1e-7, 0, 0, 0])."""
    height: int = 383
    width: int = 451
    coefficients: tuple = (3e-4, 1e-7, 0.0, 0.0, 0.0)

    def validate(self) -> None:
        if len(self.coefficients) != 5:
            raise ValueError("exactly 5 distortion coefficients required "
                             "(DeWarp.cs:46-48 semantics)")
        if self.height <= 0 or self.width <= 0:
            raise ValueError("image dimensions must be positive")


@dataclass(frozen=True)
class CameraConfig:
    fx: float = 1000.0
    fy: float = 1000.0
    cx: float = 1500.0
    cy: float = 2000.0

    def validate(self) -> None:
        if self.fx <= 0 or self.fy <= 0:
            raise ValueError("focal lengths must be positive")


@dataclass(frozen=True)
class RansacConfig:
    """Defaults per the reference driver (Program.cs:229)."""
    num_samples: int = 2000
    sample_size: int = 8
    threshold: float = 1.0
    residual: str = "sampson"

    def validate(self) -> None:
        if self.sample_size < 8:
            raise ValueError("at least 8 pairs per sample "
                             "(CameraPoseEstimation.cs:28-29)")
        if self.num_samples <= 0:
            raise ValueError("num_samples must be positive")


@dataclass(frozen=True)
class BAConfig:
    iterations: int = 20
    huber_delta: float = 3.0
    window: int = 8
    prune_px: float = 2.0

    def validate(self) -> None:
        if self.iterations <= 0 or self.window <= 0:
            raise ValueError("iterations/window must be positive")


@dataclass(frozen=True)
class PipelineConfig:
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    dewarp: DeWarpConfig = field(default_factory=DeWarpConfig)
    camera: CameraConfig = field(default_factory=CameraConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    ba: BAConfig = field(default_factory=BAConfig)

    def validate(self) -> None:
        self.dewarp.validate()
        self.camera.validate()
        self.ransac.validate()
        self.ba.validate()


def _merge(dc, overrides: dict):
    """Recursively overlay a dict onto a (frozen) dataclass."""
    updates = {}
    for f in dataclasses.fields(dc):
        if f.name not in overrides:
            continue
        val = overrides[f.name]
        cur = getattr(dc, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            updates[f.name] = _merge(cur, val)
        elif isinstance(cur, tuple) and isinstance(val, list):
            updates[f.name] = tuple(val)
        else:
            updates[f.name] = val
    unknown = set(overrides) - {f.name for f in dataclasses.fields(dc)}
    if unknown:
        raise ValueError(f"unknown config keys for {type(dc).__name__}: "
                         f"{sorted(unknown)}")
    return dataclasses.replace(dc, **updates)


def load_config(path: Optional[str] = None,
                environment: Optional[str] = None) -> PipelineConfig:
    """Base config + optional JSON file + {stem}.{environment}.json overlay.

    Mirrors the reference's appsettings layering (Program.cs:28-36); the
    environment comes from PHOTOGRAMMETRY_ENVIRONMENT when not given.
    Validates fail-fast (AddOptionsWithValidateOnStart semantics).
    """
    cfg = PipelineConfig()
    if path:
        with open(path) as fh:
            cfg = _merge(cfg, json.load(fh))
        environment = environment or os.environ.get(ENV_VAR)
        if environment:
            stem, ext = os.path.splitext(path)
            overlay = f"{stem}.{environment}{ext}"
            if os.path.isfile(overlay):
                with open(overlay) as fh:
                    cfg = _merge(cfg, json.load(fh))
    cfg.validate()
    return cfg
