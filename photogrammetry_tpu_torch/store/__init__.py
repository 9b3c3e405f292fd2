"""The content store with typed variants and the on-disk caches."""
from photogrammetry_tpu_torch.store.content_store import ContentStore, Variant
from photogrammetry_tpu_torch.store.cache import (
    DistortionMapCache, KeypointCache,
)

__all__ = ["ContentStore", "Variant", "DistortionMapCache", "KeypointCache"]
