"""Port parity: sequence-level precomputed matching
(``frontend.precompute_matching``, ``SfmConfig.precompute_matching``,
``run_sfm --precompute-matching``).

The same features (the JAX package's ``precompute_frontend`` output,
carried across) and the same RANSAC draws (JAX's per-pair keys
``fold_in(key, 2t + dt - 1)``, turned into sample indices by
``_torch_parity.jax_sample_idx``) go through both packages'
``precompute_matching`` on the 12-frame star pan at 240x320 (and its
two-octave pyramid, 1024 keypoint slots a frame).

Tolerances: ``idx1``/``idx2``/``num1``/``num2``, every shape and dtype
exactly.  ``good`` exactly against the port's own pair-by-pair
``match_pair`` + ``ransac_fundamental`` on the same draws.  The gate's
rule exactly against JAX: the port's Sampson residual and threshold,
applied to the fundamental matrix JAX's gate settled on, give JAX's
``good`` row bit for bit, for every pair.  Against JAX, ``good`` itself
is not bit-exact, and cannot be: each hypothesis is a float32 8-point
solve on 8 correspondences, the smallest eigenvector of a Gram matrix
whose condition is the square of the design matrix's.  Where the
design matrix's smallest nonzero singular value is a small share of its
largest (a repeated index makes it 0; about a third of JAX's draws,
which are with replacement, repeat one), the two packages' LAPACK
builds return different vectors and the hypothesis scores another
inlier count; a well-posed hypothesis (that share >= 1e-2) scores
within 3 of JAX's.  So the winner can differ between near-equal
consensus sets, and the LO refits settle on another near-equal one:
each pair's gated count is held within max(3, 8%) of JAX's and at most
5% of all matched entries may differ (measured: 33 of 1,425 at one
octave, 127 of 3,547 at two; counts within 5 of JAX's).  Whole runs are
held to the bounds of tests/test_incremental.py beside JAX's run with
the flag: ATE < 0.2 and > 80 landmarks.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_sample_idx
from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.parallel.mesh import make_mesh as jax_make_mesh
from photogrammetry_tpu.sfm import epipolar as jep
from photogrammetry_tpu.sfm import frontend as jf
from photogrammetry_tpu.sfm import incremental as jinc
from photogrammetry_tpu.synth.star_scene import (
    StarSceneConfig, generate_sequence,
)
from photogrammetry_tpu_torch.cli import run_sfm
from photogrammetry_tpu_torch.convert import from_jax
from photogrammetry_tpu_torch.ops.match import (
    INT_INF, mutual_nearest_matches, mutual_nearest_matches_batch,
)
from photogrammetry_tpu_torch.sfm import epipolar as ep
from photogrammetry_tpu_torch.sfm import frontend as pf
from photogrammetry_tpu_torch.sfm import incremental as inc
from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate
from photogrammetry_tpu_torch.utils.padding import PaddedPoints

CFG = jinc.SfmConfig()
H = CFG.ransac_samples // 2
THRESHOLD = CFG.ransac_threshold


@pytest.fixture(scope="module")
def pan():
    return generate_sequence(StarSceneConfig(
        num_frames=12, image_size=(240, 320), focal=260.0, supersample=2))


def _port_config(fc):
    return pf.FrontendConfig(**{k: v for k, v in vars(fc).items()
                                if not k.startswith("use_pallas")})


def _port_feats(feats):
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    return pf.DescribedFrame(points=PaddedPoints(*map(t, feats.points)),
                             bits=t(feats.bits), xy=t(feats.xy))


def _pair(feats, t, dt):
    return (jax.tree.map(lambda x: x[t], feats),
            jax.tree.map(lambda x: x[t - dt], feats))


@pytest.fixture(scope="module", params=[1, 2], ids=["octaves1", "octaves2"])
def both(request, pan):
    """JAX's PrecompMatches at PRNGKey(3), its features carried across,
    and JAX's per-pair draws as sample indices."""
    fc = CFG.frontend
    feats = jf.precompute_frontend(jnp.asarray(pan["frames"], jnp.float32),
                                   jf.make_pairs(fc), fc,
                                   octaves=request.param)
    key = jax.random.PRNGKey(3)
    ref = jf.precompute_matching(feats, fc, key, 12, THRESHOLD, H)
    samples = []
    for t, dt in pf.sequence_pairs(12):
        m = jf.match_pair(*_pair(feats, t, dt), fc)
        samples.append(jax_sample_idx(jax.random.fold_in(key, 2 * t + dt - 1),
                                      m.mask, H, 8))
    return dict(feats=feats, ref=ref, key=key, pfeats=_port_feats(feats),
                samples=torch.tensor(np.stack(samples)),
                k=feats.bits.shape[1])


def _port_pm(both, chunk=16):
    return pf.precompute_matching(both["pfeats"], _port_config(CFG.frontend),
                                  None, 12, THRESHOLD, H, chunk=chunk,
                                  sample_idx=both["samples"])


def test_precompute_matching_matches_jax(both):
    got, ref = _port_pm(both), both["ref"]
    for name in pf.PrecompMatches._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
    assert got.idx1.shape == (12, both["k"])
    for name in ("idx1", "num1", "idx2", "num2"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert not got.good1[0].any() and not got.good2[:2].any()
    assert int(got.num1[0]) == int(got.num2[1]) == 0
    assert (got.num1[1:] > 40).all()

    pfc = _port_config(CFG.frontend)
    pfeats = both["pfeats"]
    differing = total = 0
    for q, (t, dt) in enumerate(pf.sequence_pairs(12)):
        good = (got.good1 if dt == 1 else got.good2)[t]
        jgood = np.asarray((ref.good1 if dt == 1 else ref.good2)[t])
        # the port's pair by pair: the same bits as the batched path
        m = pf.match_pair(pf.frame_features(pfeats, t),
                          pf.frame_features(pfeats, t - dt), pfc)
        gate = ep.ransac_fundamental(both["samples"][q], m.xy1, m.xy2,
                                     m.mask, THRESHOLD)
        assert torch.equal(good, m.mask & gate.inliers), (t, dt)
        # JAX's gate on this pair, then the port's rule on its winner
        jm = jf.match_pair(*_pair(both["feats"], t, dt), CFG.frontend)
        jgate = jep.ransac_fundamental(
            jax.random.fold_in(both["key"], 2 * t + dt - 1), jm.xy1, jm.xy2,
            jm.mask, threshold=THRESHOLD, num_samples=H)
        np.testing.assert_array_equal(np.asarray(jm.mask & jgate.inliers),
                                      jgood)
        rule = ep.ransac_on_hypotheses(
            torch.tensor(np.asarray(jgate.f))[None],
            torch.tensor(np.asarray(jgate.best_sample))[None], m.xy1, m.xy2,
            m.mask, THRESHOLD, refit=False)
        np.testing.assert_array_equal((m.mask & rule.inliers).numpy(), jgood)
        _hold_well_posed_hypotheses(jm, m, both["samples"][q])
        n, jn = int(good.sum()), int(jgood.sum())
        assert abs(n - jn) <= max(3, 0.08 * jn), (t, dt, n, jn)
        total += int(m.mask.sum())
        differing += int((good.numpy() != jgood).sum())
    assert differing <= 0.05 * total, (differing, total)


def _design_share(xy1, xy2):
    """(H,) smallest-over-largest singular value of each hypothesis's
    (8, 9) Hartley-normalised 8-point design matrix, in float64; xy
    (H, 8, 2)."""
    def normalised(x):
        c = x - x.mean(1, keepdims=True)
        scale = np.sqrt(2) / np.maximum(
            np.linalg.norm(c, axis=-1).mean(1, keepdims=True), 1e-12)
        return c * scale[..., None]

    a, b = normalised(xy1), normalised(xy2)
    x1, y1, x2, y2 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    design = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                       np.ones_like(x1)], -1)
    s = np.linalg.svd(design, compute_uv=False)
    return s[:, -1] / s[:, 0]


def _hold_well_posed_hypotheses(jm, m, samples):
    """Each hypothesis of the pair, estimated in each package from the
    same 8 correspondences and scored by the port's rule: a well-posed
    one (design share >= 1e-2) scores within 3 inliers of JAX's."""
    idx = jnp.asarray(samples.numpy())
    jfs = jax.vmap(lambda i: jep.eight_point_fundamental(jm.xy1[i],
                                                         jm.xy2[i]))(idx)
    fs = ep.eight_point_fundamental(m.xy1[samples], m.xy2[samples])

    def counts(f):
        r = ep.epipolar_residuals(f, m.xy1, m.xy2)
        return ((r.abs() <= THRESHOLD) & m.mask).sum(-1).numpy()

    xy1 = m.xy1.numpy().astype(np.float64)
    xy2 = m.xy2.numpy().astype(np.float64)
    posed = _design_share(xy1[samples.numpy()], xy2[samples.numpy()]) >= 1e-2
    diff = np.abs(counts(torch.tensor(np.asarray(jfs))) - counts(fs))
    assert posed.any() and (diff[posed] <= 3).all(), diff[posed]


@pytest.mark.parametrize("max_ratio", [None, 0.8])
def test_mutual_nearest_batch_equals_pairwise(max_ratio):
    rng = np.random.default_rng(0)
    d = torch.tensor(rng.integers(0, 40, (5, 33, 29)), dtype=torch.int32)
    d[1, 4:9] = INT_INF                      # masked rows and columns
    d[2, :, 3] = INT_INF
    d[3] = 7                                 # all tied: first index wins
    idx, dist, valid = mutual_nearest_matches_batch(d, 30, max_ratio)
    for q in range(5):
        i1, d1, v1 = mutual_nearest_matches(d[q], 30, max_ratio)
        assert torch.equal(idx[q], i1) and torch.equal(dist[q], d1)
        assert torch.equal(valid[q], v1)
    assert idx.dtype == torch.int32
    assert int(valid[3].sum()) == (1 if max_ratio is None else 0)


def test_outputs_do_not_depend_on_chunk(both):
    """Injected draws and the port's own draws (one base seed a call, a
    generator a pair) give the same result at every chunk size."""
    ref = _port_pm(both, chunk=16)
    for chunk in (1, 5, 32):
        got = _port_pm(both, chunk=chunk)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), chunk
    pfc = _port_config(CFG.frontend)
    own = [pf.precompute_matching(both["pfeats"], pfc,
                                  torch.Generator().manual_seed(5), 12,
                                  THRESHOLD, H, chunk=chunk)
           for chunk in (1, 16)]
    assert all(torch.equal(a, b) for a, b in zip(*own))
    assert own[0].num1.equal(ref.num1) and own[0].idx2.equal(ref.idx2)


def test_sfm_with_precompute_matching_within_bounds(pan):
    cfg = inc.SfmConfig(precompute_matching=True)
    res = inc.run_incremental_sfm(pan["frames"], pan["k"], cfg, seed=0,
                                  device="cpu")
    ref = jinc.run_incremental_sfm(pan["frames"], pan["k"],
                                   jinc.SfmConfig(precompute_matching=True),
                                   seed=0)
    for r in (res, ref):
        assert trajectory_ate(np.asarray(r.rs), np.asarray(r.ts),
                              pan["centers"]) < 0.2
        assert len(r.points) > 80
    for info in res.frame_info:
        assert {"matches", "gated_matches", "chained"} <= set(info)
        assert info["matches"] >= info["gated_matches"] > 0
    assert [i["pose_init"] for i in res.frame_info][:3] == \
        [i["pose_init"] for i in ref.frame_info][:3]


def test_resume_with_precompute_matching(pan, tmp_path):
    """A snapshot at frame 3 of a flagged run resumes over 6 frames with
    the flag on (the resumed frame's skip claims start from -1): the
    tests/test_torch_checkpoint.py contract, rotations within 0.2 of the
    uninterrupted flagged run."""
    frames, k = pan["frames"][:6], pan["k"]
    cfg = inc.SfmConfig(precompute_matching=True, collect_diagnostics=False)
    full = inc.run_incremental_sfm(frames, k, cfg, device="cpu")
    path = str(tmp_path / "sfm.npz")
    inc.run_incremental_sfm(frames[:4], k, cfg, checkpoint_path=path,
                            checkpoint_every=1, device="cpu")
    shutil.copy(path, tmp_path / "kept.npz")
    resumed = inc.run_incremental_sfm(frames, k, cfg, checkpoint_path=path,
                                      device="cpu")
    assert len(resumed.costs) == 2 + 1 + cfg.final_refine_rounds
    assert np.isfinite(resumed.camera_centers).all()
    np.testing.assert_allclose(resumed.rs, full.rs, atol=0.2)


def test_run_sfm_cli_precompute_matching(tmp_path, capsys, pan):
    from PIL import Image

    for i, frame in enumerate(pan["frames"][:6]):
        Image.fromarray(frame).save(tmp_path / f"f{i:02d}.png")
    cloud, traj = tmp_path / "c.ply", tmp_path / "t.json"
    assert run_sfm.main([str(tmp_path), "--device", "cpu", "--fx", "260",
                         "--precompute-matching", "--cloud", str(cloud),
                         "--trajectory", str(traj)]) == 0
    assert cloud.exists() and traj.exists()
    assert "landmarks" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        run_sfm.main(["--device", "cpu", "--precompute-matching=1"])


def test_convert_carries_precompute_matching_and_refuses_a_mesh():
    d = dataclasses.asdict(jinc.SfmConfig(precompute_matching=True))
    _, _, cfg = from_jax(np.zeros((4, 2, 2), np.int32), np.eye(3), d,
                         device="cpu")
    assert cfg.precompute_matching is True and cfg.mesh is None
    mesh = jax_make_mesh(shape=(1,), devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="make_mesh"):
        from_jax(np.zeros((4, 2, 2), np.int32), np.eye(3),
                 {**d, "mesh": mesh}, device="cpu")
