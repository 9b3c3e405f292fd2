"""Port parity: checkpoint/resume of incremental SfM (store/checkpoint.py,
``run_incremental_sfm(checkpoint_path=...)``, ``run_sfm --checkpoint``).

The file format is the JAX package's: a checkpoint either package writes
loads in the other with every field equal exactly (names, dtypes, values),
and a run resumes from either.  The resume contract is
tests/test_pipeline_checkpoint.py::test_incremental_resume_matches_
uninterrupted's (rotations within 0.2 of the uninterrupted run), here at
240x320 so that it runs in the default suite.
"""
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.sfm.tracks import TrackTable as JaxTable
from photogrammetry_tpu.store import checkpoint as jck
from photogrammetry_tpu_torch.cli import run_sfm
from photogrammetry_tpu_torch.sfm import incremental as inc
from photogrammetry_tpu_torch.sfm.frontend import FrontendConfig
from photogrammetry_tpu_torch.sfm.tracks import TrackTable, make_track_table
from photogrammetry_tpu_torch.store import checkpoint as ck
from photogrammetry_tpu_torch.synth.star_scene import (
    StarSceneConfig, generate_sequence,
)

CFG = inc.SfmConfig(frontend=FrontendConfig(
    detection_threshold=20.0, max_keypoints=256, reduction="nms",
    suppression_radius=4.0, hamming_threshold=80), collect_diagnostics=False)


@pytest.fixture(scope="module")
def scene():
    return generate_sequence(StarSceneConfig(
        num_frames=6, image_size=(240, 320), focal=260.0, supersample=2))


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """The uninterrupted 6-frame run, and a 4-frame run checkpointing every
    frame (its last snapshot is frame 3)."""
    path = str(tmp_path_factory.mktemp("ck") / "sfm.npz")
    full = inc.run_incremental_sfm(scene["frames"], scene["k"], CFG,
                                   device="cpu")
    inc.run_incremental_sfm(scene["frames"][:4], scene["k"], CFG,
                            checkpoint_path=path, checkpoint_every=1,
                            device="cpu")
    return full, path


def _assert_same_fields(path_a, path_b):
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], name)


def test_checkpoint_roundtrip_and_jax_field_layout(tmp_path):
    table = make_track_table(4, 16, 8, device="cpu")
    table = table._replace(points=table.points.index_put(
        (torch.tensor([0]),), torch.tensor([[1.0, 2.0, 3.0]])))
    rs = torch.eye(3).repeat(4, 1, 1)
    ts = torch.zeros((4, 3))
    path = str(tmp_path / "ckpt.npz")
    ck.save_checkpoint(path, rs, ts, table, frame_index=2,
                       metadata={"x": 1})
    rs2, ts2, table2, fi, meta = ck.load_checkpoint(path, device="cpu")
    assert fi == 2 and meta == {"x": 1}
    assert isinstance(table2, TrackTable)
    for a, b in zip((rs2, ts2, *table2), (rs, ts, *table)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the JAX package's own save of the same state: the same file fields
    jtable = JaxTable(*(jnp.asarray(x.numpy()) for x in table))
    jpath = str(tmp_path / "jax.npz")
    jck.save_checkpoint(jpath, rs.numpy(), ts.numpy(), jtable, 2)
    _assert_same_fields(path, jpath)
    with np.load(path) as data:
        assert data["table_num_tracks"].shape == () \
            and data["table_num_tracks"].dtype == np.int32
        assert data["table_kp_track"].dtype == np.int32
        assert data["frame_index"].dtype == np.int32
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: nothing to refuse")
        ck.load_checkpoint(path)


def test_checkpoints_cross_packages(runs, scene, tmp_path):
    """A port-written mid-run snapshot loads in JAX with every field equal;
    JAX writes it back, and the port resumes from JAX's file exactly as
    from its own."""
    _, path = runs
    rs, ts, table, done, meta = jck.load_checkpoint(path)
    assert done == 3 and meta["frame"] == 3
    ours = ck.load_checkpoint(path, device="cpu")
    for a, b in zip((ours[0], ours[1], *ours[2]), (rs, ts, *table)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == torch.from_numpy(np.asarray(b).copy()).dtype
    jpath = str(tmp_path / "from_jax.npz")
    jck.save_checkpoint(jpath, rs, ts, table, done, metadata=meta)
    _assert_same_fields(path, jpath)
    own = str(tmp_path / "own.npz")     # a resumed run snapshots on
    shutil.copy(path, own)
    a = inc.run_incremental_sfm(scene["frames"][:5], scene["k"], CFG,
                                checkpoint_path=jpath, device="cpu")
    b = inc.run_incremental_sfm(scene["frames"][:5], scene["k"], CFG,
                                checkpoint_path=own, resume=True,
                                device="cpu")
    np.testing.assert_array_equal(a.rs, b.rs)
    np.testing.assert_array_equal(a.ts, b.ts)
    assert len(a.rs) == 5 and np.isfinite(a.camera_centers).all()


def test_incremental_resume_matches_uninterrupted(runs, scene, tmp_path):
    full, path = runs
    # the JAX test's contract: resuming the 4-frame snapshot over the same
    # 4 frames returns its state; rotations within 0.2 of the full run
    resumed = inc.run_incremental_sfm(scene["frames"][:4], scene["k"], CFG,
                                      checkpoint_path=path, device="cpu")
    assert resumed.costs == []
    np.testing.assert_allclose(resumed.rs[:4], full.rs[:4], atol=0.2)
    # and over all 6 frames: the snapshot is extended, frames 4-5 are run
    # (on a copy: the resumed run snapshots on)
    own = str(tmp_path / "own.npz")
    shutil.copy(path, own)
    longer = inc.run_incremental_sfm(scene["frames"], scene["k"], CFG,
                                     checkpoint_path=own, device="cpu")
    assert len(longer.costs) > 2 and len(longer.rs) == 6
    np.testing.assert_allclose(longer.rs, full.rs, atol=0.2)
    with pytest.raises(ValueError, match="holds 4 frames"):
        inc.run_incremental_sfm(scene["frames"][:3], scene["k"], CFG,
                                checkpoint_path=path, device="cpu")


def test_mid_run_resume_beside_jax(runs, scene, tmp_path, monkeypatch):
    """A mid-run resume resumes, in both packages, from one snapshot: the
    4-frame run's, padded in numpy to 6 frames (identity poses, empty
    observation rows: exactly what the port's own extension gives) and
    written by JAX.  Each package rebuilds the same keypoint -> track map
    for frame 3 (equal exactly: the 0.5-px re-match on the same keypoints),
    runs frames 4 and 5 and no other, and keeps frames 0-3 as the snapshot
    holds them until final BA; the two land within 0.2 of each other's
    rotations (their RANSAC draws differ)."""
    from photogrammetry_tpu.sfm import incremental as jinc
    from photogrammetry_tpu.sfm.frontend import (
        FrontendConfig as JaxFrontend,
    )

    _, path = runs
    rs, ts, table, done, _ = jck.load_checkpoint(path)
    assert done == 3
    table = JaxTable(*(np.asarray(x) for x in table))
    more = 2
    padded = (
        np.concatenate([np.asarray(rs), np.tile(np.eye(3, dtype=np.float32),
                                                (more, 1, 1))]),
        np.concatenate([np.asarray(ts), np.zeros((more, 3), np.float32)]),
        table._replace(
            obs=np.concatenate([table.obs, np.zeros(
                (more, *table.obs.shape[1:]), table.obs.dtype)]),
            obs_mask=np.concatenate([table.obs_mask, np.zeros(
                (more, table.obs_mask.shape[1]), bool)])))
    ours = ck.load_checkpoint(path, device="cpu")
    fitted = inc._fit_frames(ours[0], ours[1], ours[2], 6)
    for a, b in zip((fitted[0], fitted[1], *fitted[2]),
                    (padded[0], padded[1], *padded[2])):
        np.testing.assert_array_equal(a.numpy(), b)
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jck.save_checkpoint(jpath, *padded, done)
    shutil.copy(jpath, ppath)

    rebuilt = {}
    for name, mod in (("jax", jinc), ("port", inc)):
        real = mod.extend_tracks_with_tid

        def spy(table, *args, _name=name, _real=real):
            rebuilt.setdefault(_name, np.asarray(table.kp_track).copy())
            return _real(table, *args)

        monkeypatch.setattr(mod, "extend_tracks_with_tid", spy)
    fc = CFG.frontend
    jcfg = jinc.SfmConfig(frontend=JaxFrontend(
        detection_threshold=fc.detection_threshold,
        max_keypoints=fc.max_keypoints, reduction=fc.reduction,
        suppression_radius=fc.suppression_radius,
        hamming_threshold=fc.hamming_threshold), collect_diagnostics=False)
    ref = jinc.run_incremental_sfm(scene["frames"], scene["k"], jcfg,
                                   checkpoint_path=jpath)
    got = inc.run_incremental_sfm(scene["frames"], scene["k"], CFG,
                                  checkpoint_path=ppath, device="cpu")
    np.testing.assert_array_equal(rebuilt["port"], rebuilt["jax"])
    assert (rebuilt["port"] >= 0).sum() > 16
    for r in (ref, got):
        assert [i["frame"] for i in r.frame_info] == [4, 5]
        assert np.isfinite(np.asarray(r.ts)).all()
    np.testing.assert_allclose(got.rs, np.asarray(ref.rs), atol=0.2)


def test_checkpoint_cadence_includes_deferred_frames(scene, tmp_path):
    """Snapshots every ``checkpoint_every`` frames and at the last, deferred
    (poseless) frames too: the bootstrap waits for 50 px of motion, so
    frame 2 is deferred, and its snapshot carries no cost."""
    path = str(tmp_path / "cad.npz")
    seen = []
    real = inc.save_checkpoint

    def spy(p, rs, ts, table, t, metadata=None):
        seen.append((t, metadata["cost"] is None))
        real(p, rs, ts, table, t, metadata)

    inc.save_checkpoint = spy
    try:
        res = inc.run_incremental_sfm(scene["frames"][:5], scene["k"], CFG,
                                      checkpoint_path=path,
                                      checkpoint_every=2, device="cpu")
    finally:
        inc.save_checkpoint = real
    assert [t for t, _ in seen] == [2, 4]
    deferred = [i["frame"] for i in res.frame_info
                if i["pose_init"] == "deferred"]
    assert 2 in deferred
    assert all(none == (t in deferred) for t, none in seen)
    assert ck.load_checkpoint(path, device="cpu")[3] == 4


def test_run_sfm_checkpoint_and_no_resume(tmp_path, capsys, scene):
    from PIL import Image

    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, frame in enumerate(scene["frames"][:4]):
        Image.fromarray(frame).save(frames_dir / f"f{i:02d}.png")
    path = tmp_path / "out" / "run.npz"
    common = [str(frames_dir), "--device", "cpu", "--fx", "260", "--cx",
              "160", "--cy", "120", "--checkpoint", str(path),
              "--cloud", str(tmp_path / "c.ply"),
              "--trajectory", str(tmp_path / "t.json")]

    def report(extra=()):
        assert run_sfm.main(common + list(extra)) == 0
        out = capsys.readouterr().out.splitlines()
        return json.loads(out[0])

    first = report()
    assert path.exists() and first["final_cost"] is not None
    assert ck.load_checkpoint(str(path), device="cpu")[3] == 3
    resumed = report()      # the snapshot is at the last frame: no new BA
    assert resumed["final_cost"] is None and resumed["frames"] == 4
    fresh = report(["--no-resume"])
    assert fresh["final_cost"] == first["final_cost"]
    assert fresh["landmarks"] == first["landmarks"]
    with pytest.raises(SystemExit):
        run_sfm.main(common + ["--restarts", "2"])
