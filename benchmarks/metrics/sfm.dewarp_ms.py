"""Mean wall time of the dewarp stage a sequence: the span around the
benchmark's call of cli.run_sfm.dewarp_frames, ending in a synchronize
(map read from the cache, upload, remap)."""


def read(run):
    got = [s.end - s.start for s in run.spans if s.name == "dewarp"]
    return 1e3 * sum(got) / len(got) if got else None
