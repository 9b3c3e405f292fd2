"""Port parity: core/lie.py and sfm/tracks.py.

The same numpy inputs, made from a seed, go through the JAX function and
its port on the CPU.  Tolerances: the Lie functions within rtol 1e-4 /
atol 1e-5 (f32 transcendental and matmul rounding differ between XLA and
torch); the track functions exactly (they copy coordinates and count, so
any difference is a bug) — including capacity overflow and the
out-of-bounds sentinel, which the port writes to a spare row instead of
JAX's ``mode="drop"``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.core import lie as jlie
from photogrammetry_tpu.sfm import tracks as jtr
from photogrammetry_tpu_torch.core import lie
from photogrammetry_tpu_torch.sfm import tracks as ptr

LIE_TOL = dict(rtol=1e-4, atol=1e-5)


def _twists(seed, scale, n=64):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[:, :3] *= scale / np.linalg.norm(xi[:, :3], axis=1, keepdims=True)
    return xi


# angles: exactly 0, inside the Taylor branches, moderate, near pi
@pytest.mark.parametrize("scale", [0.0, 1e-5, 3e-3, 0.7, 3.1])
def test_lie_functions_match_jax(scale):
    xi = _twists(int(scale * 1000), scale)
    w = xi[:, :3]
    np.testing.assert_array_equal(lie.so3_hat(torch.tensor(w)).numpy(),
                                  np.asarray(jlie.so3_hat(w)))
    r = lie.so3_exp(torch.tensor(w))
    np.testing.assert_allclose(r.numpy(), np.asarray(jlie.so3_exp(w)),
                               **LIE_TOL)
    r_np = np.asarray(jlie.so3_exp(w))
    np.testing.assert_allclose(lie.so3_log(torch.tensor(r_np)).numpy(),
                               np.asarray(jlie.so3_log(r_np)), **LIE_TOL)
    rr, tt = lie.se3_exp(torch.tensor(xi))
    jr, jt = jlie.se3_exp(xi)
    np.testing.assert_allclose(rr.numpy(), np.asarray(jr), **LIE_TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **LIE_TOL)
    jr, jt = np.asarray(jr), np.asarray(jt)
    np.testing.assert_allclose(
        lie.se3_log(torch.tensor(jr), torch.tensor(jt)).numpy(),
        np.asarray(jlie.se3_log(jr, jt)), **LIE_TOL)


def _same_table(got: ptr.TrackTable, ref: jtr.TrackTable):
    for name in ptr.TrackTable._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)


def _tables(num_frames, capacity, max_keypoints):
    return (ptr.make_track_table(num_frames, capacity, max_keypoints,
                                 device="cpu"),
            jtr.make_track_table(num_frames, capacity, max_keypoints))


@pytest.mark.parametrize("capacity", [2, 5, 64])
def test_start_and_extend_match_jax(capacity):
    """start_tracks / extend_tracks / extend_tracks_with_tid over four
    random frames, below and beyond capacity (dropped keypoints counted,
    sentinel writes never aliased onto a real track)."""
    rng = np.random.default_rng(capacity)
    kps = 12
    got, ref = _tables(4, capacity, kps)
    xy = rng.uniform(0, 100, (kps, 2)).astype(np.float32)
    mask = rng.random(kps) > 0.3
    got = ptr.start_tracks(got, 0, torch.tensor(xy), torch.tensor(mask))
    ref = jtr.start_tracks(ref, jnp.int32(0), xy, mask)
    _same_table(got, ref)
    for f in (1, 2, 3):
        xy = rng.uniform(0, 100, (kps, 2)).astype(np.float32)
        mask = rng.random(kps) > 0.2
        if f == 2:
            match_prev = rng.integers(-1, kps, kps).astype(np.int32)
            valid = rng.random(kps) > 0.3
            old, before = got, got.obs.clone()
            got = ptr.extend_tracks(got, f, torch.tensor(xy),
                                    torch.tensor(mask),
                                    torch.tensor(match_prev),
                                    torch.tensor(valid))
            ref = jtr.extend_tracks(ref, jnp.int32(f), xy, mask, match_prev,
                                    valid)
        else:
            # distinct track ids (as the matcher produces), some -1
            tid = np.where(rng.random(kps) > 0.4,
                           rng.permutation(max(capacity, kps))[:kps],
                           -1).astype(np.int32)
            tid = np.where(tid < capacity, tid, -1).astype(np.int32)
            old, before = got, got.obs.clone()
            got = ptr.extend_tracks_with_tid(got, f, torch.tensor(xy),
                                             torch.tensor(mask),
                                             torch.tensor(tid))
            ref = jtr.extend_tracks_with_tid(ref, jnp.int32(f), xy, mask,
                                             jnp.asarray(tid))
        _same_table(got, ref)
        assert torch.equal(old.obs, before)   # the input table is intact
    if capacity < kps:
        assert int(got.dropped) > 0


def test_start_tracks_capacity_drop():
    """tests/test_incremental.py::test_track_capacity_drop on the port."""
    got, ref = _tables(2, 2, 4)
    xy = np.arange(8, dtype=np.float32).reshape(4, 2)
    got = ptr.start_tracks(got, 0, torch.tensor(xy), torch.ones(4, dtype=bool))
    ref = jtr.start_tracks(ref, jnp.int32(0), xy, np.ones(4, bool))
    _same_table(got, ref)
    assert int(got.num_tracks) == 2 and int(got.dropped) == 2


def _merge_both(args, capacity):
    got = ptr.merge_skip_matches(*(torch.tensor(a) for a in args),
                                 capacity=capacity)
    ref = jtr.merge_skip_matches(*(jnp.asarray(a) for a in args),
                                 capacity=capacity)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    return got.numpy()


def test_merge_skip_matches_priorities_and_collisions():
    """The cases of tests/test_incremental.py: t-1 wins, a claimed track
    is not re-claimed, colliding t-2 claims keep the lowest keypoint."""
    args = (np.array([5, 6, -1, 7], np.int32), np.array([5, 8, 9, -1],
                                                         np.int32),
            np.array([0, -1, -1, -1], np.int32),
            np.array([True, False, False, False]),
            np.array([-1, 1, 0, 2], np.int32),
            np.array([False, True, True, True]))
    np.testing.assert_array_equal(_merge_both(args, 16), [5, 8, -1, 9])
    args = (np.array([-1, -1], np.int32), np.array([3, 3], np.int32),
            np.array([-1, -1], np.int32), np.array([False, False]),
            np.array([0, 1], np.int32), np.array([True, True]))
    np.testing.assert_array_equal(_merge_both(args, 8), [3, -1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_skip_matches_random(seed):
    rng = np.random.default_rng(seed)
    k, cap = 40, 30
    kp1 = np.where(rng.random(k) > 0.2, rng.integers(0, cap, k), -1)
    kp2 = np.where(rng.random(k) > 0.2, rng.integers(0, cap, k), -1)
    args = (kp1.astype(np.int32), kp2.astype(np.int32),
            rng.integers(-1, k, k).astype(np.int32), rng.random(k) > 0.5,
            rng.integers(-1, k, k).astype(np.int32), rng.random(k) > 0.3)
    _merge_both(args, cap)


def _landmark_table(rng, kps=6, cap=10):
    """Frame 0 observes kps tracks, half of them triangulated; frame 1's
    keypoints opened fresh singletons (a broken chain)."""
    kmat = np.array([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]], np.float32)
    pts = np.concatenate([rng.uniform(-1, 1, (kps, 2)),
                          rng.uniform(4, 6, (kps, 1))], 1).astype(np.float32)
    proj = pts[:, :2] / pts[:, 2:] * 100 + 50
    got, ref = _tables(2, cap, kps)
    m0 = np.ones(kps, bool)
    got = ptr.start_tracks(got, 0, torch.tensor(proj), torch.tensor(m0))
    ref = jtr.start_tracks(ref, jnp.int32(0), proj, m0)
    has = np.zeros(cap, bool)
    has[:kps:2] = True
    points = np.zeros((cap, 3), np.float32)
    points[:kps] = pts
    got = got._replace(points=torch.tensor(points), has_point=torch.tensor(has))
    ref = ref._replace(points=jnp.asarray(points), has_point=jnp.asarray(has))
    xy1 = (proj + rng.normal(0, 1.0, proj.shape)).astype(np.float32)
    m1 = rng.random(kps) > 0.1
    tid = np.full(kps, -1, np.int32)
    got = ptr.extend_tracks_with_tid(got, 1, torch.tensor(xy1),
                                     torch.tensor(m1), torch.tensor(tid))
    ref = jtr.extend_tracks_with_tid(ref, jnp.int32(1), xy1, m1,
                                     jnp.asarray(tid))
    return got, ref, xy1, m1, kmat


@pytest.mark.parametrize("seed,radius", [(0, 4.0), (1, 4.0), (2, 0.5)])
def test_reassociate_to_landmarks_matches_jax(seed, radius):
    rng = np.random.default_rng(seed)
    got, ref, xy1, m1, kmat = _landmark_table(rng)
    obs_mask_before = got.obs_mask.clone()
    got, n = ptr.reassociate_to_landmarks(
        got, 1, torch.tensor(xy1), torch.tensor(m1), torch.eye(3),
        torch.zeros(3), torch.tensor(kmat), radius)
    ref, n_ref = jtr.reassociate_to_landmarks(
        ref, jnp.int32(1), jnp.asarray(xy1), jnp.asarray(m1), jnp.eye(3),
        jnp.zeros(3), jnp.asarray(kmat), jnp.float32(radius))
    _same_table(got, ref)
    assert int(n) == int(n_ref)
    if radius > 1:
        assert int(n) >= 1
        assert not torch.equal(obs_mask_before, got.obs_mask)


def test_reassociate_reclaims_fragment():
    """tests/test_incremental.py::test_reassociate_to_landmarks_reclaims_
    fragment on the port."""
    table = ptr.make_track_table(2, 8, 2, device="cpu")
    k = torch.tensor([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]])
    table = ptr.start_tracks(table, 0, torch.tensor([[50.0, 50], [10, 10]]),
                             torch.tensor([True, False]))
    points = table.points.clone()
    points[0] = torch.tensor([0.0, 0, 5])
    has = table.has_point.clone()
    has[0] = True
    table = table._replace(points=points, has_point=has)
    xy1 = torch.tensor([[50.5, 50.5], [0, 0]])
    table = ptr.extend_tracks_with_tid(table, 1, xy1,
                                       torch.tensor([True, False]),
                                       torch.tensor([-1, -1],
                                                    dtype=torch.int32))
    assert bool(table.obs_mask[1, 1])
    table, n = ptr.reassociate_to_landmarks(
        table, 1, xy1, torch.tensor([True, False]), torch.eye(3),
        torch.zeros(3), k, 4.0)
    assert int(n) == 1
    assert bool(table.obs_mask[1, 0]) and not bool(table.obs_mask[1, 1])
    assert int(table.kp_track[0]) == 0


def test_first_last_observations_match_jax():
    rng = np.random.default_rng(5)
    got, ref = _tables(6, 20, 4)
    mask = rng.random((6, 20)) > 0.6
    got = got._replace(obs_mask=torch.tensor(mask))
    ref = ref._replace(obs_mask=jnp.asarray(mask))
    for a, b in zip(ptr.first_last_observations(got),
                    jtr.first_last_observations(ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == torch.int32
