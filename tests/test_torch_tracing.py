"""The program's spans and counters (``utils/profiling.py``): off, nothing
is recorded and no clock is read; on (a ``recording()`` scope or a
``torch.profiler`` session), the spans nest and sum as stated; the SfM
loop, BA, the dewarp stage and the pose frontend record their sites, and
a run gives the same bits with recording on and off."""
import contextlib

import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu_torch.utils import profiling

STAGES = ("sfm.sequence", "sfm.frontend", "sfm.track", "sfm.bootstrap",
          "sfm.localize", "sfm.map", "sfm.host_read", "sfm.checkpoint",
          "sfm.final_ba", "sfm.export", "ba.solve", "frontend.detect",
          "frontend.describe", "frontend.match")


@pytest.fixture(autouse=True)
def _empty():
    profiling.clear()
    yield
    profiling.clear()


class _Clock:
    """A fake ``perf_counter`` that counts its reads, a second a read."""

    def __init__(self):
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return float(self.reads)


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(profiling.time, "perf_counter", clock)
    a, b = profiling.span("x"), profiling.span("y", t=1)
    assert a is b
    with a as got:
        with b:
            profiling.count("c", 1)
            profiling.count("d", torch.tensor(True))
    assert got is None and clock.reads == 0
    assert profiling.spans() == [] and profiling.read_counters() == {}


def _profiler_cpu():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("scope", [profiling.recording, _profiler_cpu])
def test_records_inside_the_scope_only(scope):
    with scope():
        with profiling.span("inside", t=3):
            profiling.count("n", 2)
    with profiling.span("after"):
        profiling.count("n", 5)
    got = profiling.spans()
    assert [s.name for s in got] == ["inside"]
    assert got[0].attrs == {"t": 3} and got[0].end >= got[0].start
    assert profiling.read_counters() == {"n": 2}


def test_parents_roots_and_self_time(monkeypatch):
    monkeypatch.setattr(profiling.time, "perf_counter", _Clock())
    with profiling.recording():
        with profiling.span("root"):            # 1 .. 8
            with profiling.span("a"):           # 2 .. 5
                with profiling.span("b"):       # 3 .. 4
                    pass
            with profiling.span("a"):           # 6 .. 7
                pass
        with profiling.span("other"):           # 9 .. 10
            pass
    root, a1, b, a2, other = profiling.spans()
    assert (root.parent, a1.parent, b.parent, a2.parent) == (0, root.id,
                                                             a1.id, root.id)
    assert {s.root for s in (root, a1, b, a2)} == {root.id}
    assert other.parent == 0 and other.root == other.id
    assert profiling.span_summary() == {
        "a": {"calls": 2, "total_s": 4.0, "self_s": 3.0},
        "b": {"calls": 1, "total_s": 1.0, "self_s": 1.0},
        "other": {"calls": 1, "total_s": 1.0, "self_s": 1.0},
        "root": {"calls": 1, "total_s": 7.0, "self_s": 3.0}}


def test_buffer_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording():
        for _ in range(5):
            with profiling.span("s"):
                profiling.count("flag", torch.tensor(True))
    assert len(profiling.spans()) == 3
    assert profiling.read_counters() == {"flag": 3, profiling.DROPPED: 4}


def test_graph_capture_records_nothing(monkeypatch):
    from photogrammetry_tpu_torch.utils import graphs

    with profiling.recording():
        monkeypatch.setattr(graphs, "_ACTIVE", object())
        with profiling.span("captured"):
            profiling.count("n", 1)
        monkeypatch.setattr(graphs, "_ACTIVE", None)
        with profiling.span("replayed"):
            pass
    assert [s.name for s in profiling.spans()] == ["replayed"]
    assert profiling.read_counters() == {}


def test_count_launch_defers_to_the_replays(monkeypatch):
    """A kernel launch counted during a capture, which runs nothing, goes
    on the capture's list for its replays; outside one it counts at once."""
    from types import SimpleNamespace

    from photogrammetry_tpu_torch.utils import graphs

    def wrapper():
        pass

    wrapper.launches = 0
    graphs.count_launch(wrapper)
    assert wrapper.launches == 1
    capture = SimpleNamespace(launches=[])
    monkeypatch.setattr(graphs, "_ACTIVE", capture)
    graphs.count_launch(wrapper)
    assert wrapper.launches == 1 and capture.launches == [wrapper]


# -- the sites ----------------------------------------------------------


@pytest.fixture(scope="module")
def pan6():
    from photogrammetry_tpu_torch.synth.star_scene import (
        StarSceneConfig, generate_sequence,
    )

    return generate_sequence(StarSceneConfig(
        num_frames=6, image_size=(240, 320), focal=130.0))


def _sfm(pan6, cfg, recorded, **kwargs):
    from photogrammetry_tpu_torch.sfm.incremental import run_incremental_sfm

    profiling.clear()
    scope = profiling.recording() if recorded else contextlib.nullcontext()
    with scope:
        res = run_incremental_sfm(pan6["frames"], pan6["k"], cfg, seed=5,
                                  device="cpu", **kwargs)
    return res, profiling.spans()


def _same_bits(a, b):
    assert np.array_equal(a.rs, b.rs) and np.array_equal(a.ts, b.ts)
    assert a.costs == b.costs
    for x, y in zip(a.table, b.table):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def staged(pan6, tmp_path_factory):
    """The staged run with diagnostics and a checkpoint, recorded and not
    (the spans of the recorded one)."""
    from photogrammetry_tpu_torch.sfm.incremental import SfmConfig

    cfg = SfmConfig(collect_diagnostics=True)
    root = tmp_path_factory.mktemp("ckpt")
    on, spans = _sfm(pan6, cfg, True, checkpoint_path=str(root / "a.npz"),
                     resume=False)
    off, none = _sfm(pan6, cfg, False, checkpoint_path=str(root / "b.npz"),
                     resume=False)
    assert none == []
    return on, off, spans


def test_sfm_records_every_stage(staged):
    _, _, spans = staged
    names = {s.name for s in spans}
    assert set(STAGES) <= names, set(STAGES) - names
    seq = [s for s in spans if s.name == "sfm.sequence"]
    assert len(seq) == 1 and seq[0].attrs == {"frames": 6}
    root = seq[0]
    assert all(s.root == root.id for s in spans)
    children = [s for s in spans if s.parent == root.id]
    covered = sum(s.end - s.start for s in children)
    assert covered >= 0.9 * (root.end - root.start)
    # BA runs under whichever stage called it
    parents = {s.id: s.name for s in spans}
    assert {parents[s.parent] for s in spans if s.name == "ba.solve"} == {
        "sfm.bootstrap", "sfm.localize", "sfm.map", "sfm.final_ba"}


def test_sfm_same_bits_recorded_or_not(staged):
    on, off, _ = staged
    _same_bits(on, off)


def test_fused_step_records_its_span(pan6):
    from photogrammetry_tpu_torch.sfm.incremental import SfmConfig

    cfg = SfmConfig(collect_diagnostics=False, fused_steady_steps=True)
    on, spans = _sfm(pan6, cfg, True)
    off, _ = _sfm(pan6, cfg, False)
    _same_bits(on, off)
    steps = [s for s in spans if s.name == "sfm.steady_step"]
    fused = [i for i in on.frame_info if i["pose_init"] == "fused_step"]
    assert len(steps) == len(fused) >= 1
    # eager on the CPU: the stages run inside the step
    inside = {s.name for s in spans if s.parent in {x.id for x in steps}}
    assert {"sfm.track", "sfm.localize", "sfm.map"} <= inside


def _ba_problem(seed):
    from photogrammetry_tpu_torch.core.lie import se3_exp
    from photogrammetry_tpu_torch.sfm.ba import BAProblem, BAState, project

    g = torch.Generator().manual_seed(seed)
    f, t = 4, 60
    k = torch.tensor([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    pts = torch.randn(t, 3, generator=g) + torch.tensor([0.0, 0.0, 6.0])
    twist = 0.1 * torch.randn(f, 6, generator=g)
    twist[0] = 0
    rs, ts = se3_exp(twist)
    obs, _, _ = project(rs, ts, pts, k)
    obs = obs + torch.randn(obs.shape, generator=g)
    mask = torch.rand(f, t, generator=g) > 0.1
    noisy = BAState(rs=rs, ts=ts + 0.05 * torch.randn(f, 3, generator=g),
                    points=pts + 0.1 * torch.randn(t, 3, generator=g))
    return noisy, BAProblem(obs=obs, mask=mask, k=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_lm_counters_equal_a_recount(seed):
    """An LM step is accepted exactly when the cost falls, so the costs of
    the same solve cut after 0, 1, ..., n iterations recount its accept
    decisions."""
    from photogrammetry_tpu_torch.sfm.ba import bundle_adjust

    state, prob = _ba_problem(seed)
    n = 8
    with profiling.recording():
        bundle_adjust(state, prob, num_iterations=n)
    got = profiling.read_counters()
    profiling.clear()
    costs = [float(bundle_adjust(state, prob, num_iterations=i).cost)
             for i in range(n + 1)]
    accepted = sum(b < a for a, b in zip(costs, costs[1:]))
    assert got == {"ba.lm_iterations": n, "ba.lm_accepted": accepted}
    assert accepted > 0


def test_dewarp_frames_records_its_spans(tmp_path):
    from photogrammetry_tpu_torch.cli.run_sfm import dewarp_frames

    frames = np.random.default_rng(0).uniform(0, 255, (3, 48, 64)).astype(
        np.float32)
    coeffs = [3e-4, 1e-7, 0.0, 0.0, 0.0]
    with profiling.recording():
        dewarp_frames(frames, coeffs, str(tmp_path), device="cpu")
    assert [s.name for s in profiling.spans()] == [
        "dewarp.map_load", "dewarp.map_upload", "dewarp.frames_upload",
        "dewarp.remap"]


@pytest.mark.parametrize("octaves", [1, 2])
def test_pose_frontend_records_its_spans(pan6, octaves):
    from photogrammetry_tpu_torch.cli.estimate_pose import frontend
    from photogrammetry_tpu_torch.sfm.frontend import (
        FrontendConfig, make_pairs,
    )

    cfg = FrontendConfig(detection_threshold=20.0, suppression_radius=4.0,
                         max_keypoints=256)
    g1, g2 = (torch.as_tensor(pan6["frames"][i], dtype=torch.float32)
              for i in (0, 2))
    pairs = make_pairs(cfg, device="cpu")
    off = frontend(g1, g2, pairs, cfg, octaves)
    with profiling.recording():
        on = frontend(g1, g2, pairs, cfg, octaves)
    names = [s.name for s in profiling.spans()]
    assert names == (["frontend.detect", "frontend.describe",
                      "frontend.detect"] * 2 * octaves + ["frontend.match"])
    assert torch.equal(on[2].idx2, off[2].idx2)
    assert torch.equal(on[0].bits, off[0].bits)
