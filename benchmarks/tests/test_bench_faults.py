"""A run with the timed path broken underneath comes out not correct:
skipping only the look for a card, a cut cell runs on the CPU with one
fault planted in the port, for each fault its cells can have (a token or
an answer altered where it is produced: a keypoint, an epipolar gate's
labels, a dewarped pixel, a match, a pose; a step that returns its state
unchanged)."""
import _paths  # noqa: F401
import math

import torch

import readings
from _tiny import rehearse
from photogrammetry_tpu_torch.cli import estimate_pose
from photogrammetry_tpu_torch.sfm import incremental, two_view
from photogrammetry_tpu_torch.sfm.ba import BAResult


def not_correct(cell):
    result, code = rehearse(cell)
    assert code == 0
    assert result["attempted"] >= 1
    return not result["correct"], result["checks"]


def test_sfm_keypoint_moved_in_the_frontend(monkeypatch):
    orig = incremental.precompute_frontend

    def faulty(*args, **kwargs):
        out = orig(*args, **kwargs)
        xy = out.xy.clone()
        xy[0, :, 0] += 0.05                 # frame 0's refined positions
        return out._replace(xy=xy)

    monkeypatch.setattr(incremental, "precompute_frontend", faulty)
    bad, checks = not_correct("sfm_picam1080.pan12")
    assert bad and checks["obs_px"]["value"] >= 0.05 - 1e-6


def test_sfm_gate_labels_inverted(monkeypatch):
    readings.FAULTS["gate_inverted"](monkeypatch.setattr)
    bad, checks = not_correct("sfm_picam1080.pan12")
    assert bad and checks["gate_escapes"]["value"] > \
        checks["gate_escapes"]["limit"]


def test_sfm_bundle_adjustment_returns_its_state(monkeypatch):
    orig = incremental.bundle_adjust

    def unchanged(state, prob, *args, **kwargs):
        res = orig(state, prob, *args, **kwargs)
        return BAResult(state=state, cost=res.initial_cost,
                        initial_cost=res.initial_cost,
                        iterations=res.iterations)

    monkeypatch.setattr(incremental, "bundle_adjust", unchanged)
    bad, checks = not_correct("sfm_picam1080.pan12")
    assert bad and checks["ba_decrement"]["value"] > \
        checks["ba_decrement"]["limit"]


def test_dewarped_frame_altered(monkeypatch):
    from photogrammetry_tpu_torch.cli import run_sfm
    orig = run_sfm.dewarp_frames

    def faulty(*args, **kwargs):
        out = orig(*args, **kwargs).clone()
        out[2, 100, 100] += 8.0
        return out

    monkeypatch.setattr(run_sfm, "dewarp_frames", faulty)
    bad, checks = not_correct("sfm_picam1080.pan12_raw")
    assert bad and checks["dewarp_grey"]["value"] >= 8.0 - 1.0


def test_pose_match_altered(monkeypatch):
    orig = estimate_pose.frontend

    def faulty(*args, **kwargs):
        f1, f2, m = orig(*args, **kwargs)
        row = int(torch.nonzero(m.mask)[0, 0])
        idx2 = m.idx2.clone()
        idx2[row] = (idx2[row] + 1) % m.idx2.shape[0]
        return f1, f2, m._replace(idx2=idx2)

    monkeypatch.setattr(estimate_pose, "frontend", faulty)
    bad, checks = not_correct("pose_lego12mp.pairs")
    assert bad and checks["matches"]["value"] >= 1


def test_pose_answer_altered(monkeypatch):
    orig = two_view.two_view_pipeline
    c, s = math.cos(math.radians(1.0)), math.sin(math.radians(1.0))

    def faulty(*args, **kwargs):
        out = orig(*args, **kwargs)
        turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                            dtype=out.r.dtype, device=out.r.device)
        return out._replace(r=turn @ out.r)

    monkeypatch.setattr(two_view, "two_view_pipeline", faulty)
    bad, checks = not_correct("pose_lego12mp.pairs")
    assert bad and checks["pose_gap_deg"]["value"] > 0.9
