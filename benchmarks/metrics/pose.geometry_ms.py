"""Mean wall time of the geometry a pair: the span around
two_view_pipeline and the read-back of R, t, the inliers and the
points."""


def read(run):
    got = [s.end - s.start for s in run.spans if s.name == "geometry"]
    return 1e3 * sum(got) / len(got) if got else None
