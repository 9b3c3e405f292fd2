"""Staged pipeline runner over the content store.

Reference: the TPL-Dataflow "PipelinesV3" runtime — step factories produce
linked blocks that pass MetadataStoreRecord tokens, each stage fetching its
input variant and storing its output variant
(ImageProcessing/PipelinesV3/*.cs, wired in TestService.cs:137-152).

Port of photogrammetry_tpu/store/pipeline.py.  A Stage is (name,
input_variant, output_variant, fn); records carry GUIDs while blobs may be
tensors on the card, so chaining stages keeps data device-resident end to
end.  Stages run sequentially (one record at a time) or overlapped across
records with a thread pool: CUDA launches are asynchronous and each host
thread launches on its own current stream, so a thread per in-flight
record overlaps host work (decode, draw, encode) with device work.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, List, Sequence

from photogrammetry_tpu_torch.store.content_store import ContentStore, Variant
from photogrammetry_tpu_torch.utils.profiling import StageTimer


@dataclass(frozen=True)
class Stage:
    name: str
    input: Variant
    output: Variant
    fn: Callable[..., Any]
    # Additional earlier variants fetched from the record and passed as
    # extra positional args to fn: the reference's drawer stage fetches
    # both the dewarped image and the denoised keypoints from the store;
    # this is that pattern without widening the linear chain contract.
    extra_inputs: tuple = ()


class Pipeline:
    """Linear chain of stages mediated by a ContentStore."""

    def __init__(self, stages: Sequence[Stage], store: ContentStore | None = None):
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        for a, b in zip(stages, stages[1:]):
            if a.output != b.input:
                raise ValueError(
                    f"stage {a.name!r} outputs {a.output} but {b.name!r} "
                    f"expects {b.input}")
        self.stages = list(stages)
        self.store = store or ContentStore()
        self.timer = StageTimer()

    def submit(self, blob: Any) -> str:
        """Create a record seeded with the first stage's input variant."""
        rid = self.store.create_record()
        self.store.store(rid, self.stages[0].input, blob)
        return rid

    def run_record(self, record_id: str) -> str:
        for stage in self.stages:
            blob = self.store.fetch(record_id, stage.input)
            extras = [self.store.fetch(record_id, v)
                      for v in stage.extra_inputs]
            with self.timer.stage(stage.name):
                out = stage.fn(blob, *extras)
            self.store.store(record_id, stage.output, out)
        return record_id

    def run(self, blobs: Sequence[Any], max_workers: int = 1) -> List[str]:
        """Push all blobs through the pipeline; returns record ids in order.

        max_workers > 1 overlaps records across stages (the reference posts
        multiple images through one linked pipeline, TestService.cs:85-87).
        """
        rids = [self.submit(b) for b in blobs]
        if max_workers <= 1:
            for rid in rids:
                self.run_record(rid)
        else:
            with ThreadPoolExecutor(max_workers=max_workers) as pool:
                list(pool.map(self.run_record, rids))
        return rids
