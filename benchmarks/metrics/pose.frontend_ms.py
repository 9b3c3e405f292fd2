"""Mean wall time of the frontend a pair: the span around the upload of
both frames and cli.estimate_pose.frontend, ending in a synchronize as the
CLI's StageTimer does."""


def read(run):
    got = [s.end - s.start for s in run.spans if s.name == "frontend"]
    return 1e3 * sum(got) / len(got) if got else None
