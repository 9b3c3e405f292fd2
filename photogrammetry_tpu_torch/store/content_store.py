"""Content store with typed variants — the reference's dataflow backbone.

Reference: dotnet_src/Storage/PhotogrammetryStore/MetadataStore.cs:11-142 and
MetadataVariant.cs:3-11 — records (GUIDs) map variants (Rgba64, Greyscale,
Keypoints, DeWarped*, DeNoisedKeypoints) to blobs; pipeline stages pass only
record tokens and fetch/store variants (DeWarpTransformStepFactory.cs:51-62).

Port of photogrammetry_tpu/store/content_store.py (pure Python).  Blobs are
whatever a stage returns (tensors on the card, numpy arrays, paths), so a
record flowing through the pipeline is a handle to device-resident data and
the store never forces a host round trip.  The one-variant-per-record
invariant of the reference (MetadataStore.cs:118-121) is kept; the clock is
injectable for tests.
"""
from __future__ import annotations

import enum
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict


class Variant(enum.Enum):
    """Typed stage variants (superset of MetadataVariant.cs:3-11)."""
    SOURCE = "source"            # file path, pre-read
    OVERLAY = "overlay"          # diagnostic image with drawn keypoints
    ARTIFACT = "artifact"        # written output path
    RGB = "rgb"
    GRAYSCALE = "grayscale"
    DEWARPED_RGB = "dewarped_rgb"
    DEWARPED_GRAYSCALE = "dewarped_grayscale"
    KEYPOINTS = "keypoints"
    DENOISED_KEYPOINTS = "denoised_keypoints"
    DESCRIPTORS = "descriptors"
    MATCHES = "matches"
    POSE = "pose"
    POINT_CLOUD = "point_cloud"


@dataclass
class Record:
    created_at: float
    variants: Dict[Variant, Any] = field(default_factory=dict)


class ContentStore:
    """Thread-safe record → {variant → blob} store."""

    def __init__(self, clock: Callable[[], float] = time.time):
        self._clock = clock
        self._records: Dict[str, Record] = {}
        self._lock = threading.Lock()

    def create_record(self) -> str:
        rid = str(uuid.uuid4())
        with self._lock:
            self._records[rid] = Record(created_at=self._clock())
        return rid

    def store(self, record_id: str, variant: Variant, blob: Any) -> None:
        with self._lock:
            rec = self._records.get(record_id)
            if rec is None:
                raise KeyError(f"unknown record {record_id}")
            if variant in rec.variants:
                # one-variant-per-record invariant (MetadataStore.cs:118-121)
                raise ValueError(
                    f"record {record_id} already has variant {variant}")
            rec.variants[variant] = blob

    def fetch(self, record_id: str, variant: Variant) -> Any:
        with self._lock:
            rec = self._records.get(record_id)
            if rec is None:
                raise KeyError(f"unknown record {record_id}")
            if variant not in rec.variants:
                raise KeyError(
                    f"record {record_id} has no variant {variant}")
            return rec.variants[variant]

    def has(self, record_id: str, variant: Variant) -> bool:
        with self._lock:
            rec = self._records.get(record_id)
            return rec is not None and variant in rec.variants

    def created_at(self, record_id: str) -> float:
        with self._lock:
            return self._records[record_id].created_at

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)
