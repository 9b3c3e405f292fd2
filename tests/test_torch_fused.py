"""Port parity: the fused steady step (``SfmConfig.fused_steady_steps``,
``run_incremental_sfm_fused``), ``SfmConfig.read_free`` and the
device-side result (``export=False``, ``DeviceSfmResult``,
``export_sfm_result``), on the 8-frame 480x640 star-scene pan of
tests/test_torch_sfm.py with diagnostics off.

On the CPU the fused step is ``_steady_frame`` run eagerly, the function
the staged loop calls for a steady frame, so the fused and scan runs are
held to the staged run bit for bit (rs, ts, landmarks, costs), as the
JAX package holds its own (tests/test_incremental.py:195-250); on the
card the captured graphs are held to the same bits by
tests/test_torch_cuda.py.  The port draws its RANSAC samples from a
``torch.Generator``, so a whole run is compared with the JAX package's
only through the bounds of tests/test_incremental.py: ATE < 0.2 scene
units and > 80 landmarks, and the read-free bootstrap frame exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.sfm import incremental as jinc
from photogrammetry_tpu.sfm.metrics import absolute_trajectory_error
from photogrammetry_tpu.synth.star_scene import (
    StarSceneConfig, generate_sequence,
)
from photogrammetry_tpu_torch.convert import from_jax
from photogrammetry_tpu_torch.sfm import incremental as inc
from photogrammetry_tpu_torch.sfm import run_incremental_sfm_fused
from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate
from photogrammetry_tpu_torch.utils.graphs import (
    sync_point, tree_leaves, tree_map,
)
from photogrammetry_tpu_torch.utils.indexing import put_row, take_row

CFG = inc.SfmConfig(collect_diagnostics=False)


@pytest.fixture(scope="module")
def pan():
    """The 8-frame 480x640 pan of tests/test_incremental.py."""
    return generate_sequence(StarSceneConfig(num_frames=8, supersample=2))


@pytest.fixture(scope="module")
def staged(pan):
    """The staged runs, by (seed, precompute_matching)."""
    runs = {}

    def get(seed, pm=False):
        if (seed, pm) not in runs:
            runs[seed, pm] = inc.run_incremental_sfm(
                pan["frames"], pan["k"],
                dataclasses.replace(CFG, precompute_matching=pm), seed=seed,
                device="cpu")
        return runs[seed, pm]

    return get


@pytest.fixture(scope="module")
def read_free(pan):
    return inc.run_incremental_sfm(
        pan["frames"], pan["k"], dataclasses.replace(CFG, read_free=True),
        seed=0, device="cpu")


def _assert_same_run(a, b):
    np.testing.assert_array_equal(a.rs, b.rs)
    np.testing.assert_array_equal(a.ts, b.ts)
    assert torch.equal(a.table.points, b.table.points)
    assert a.costs == b.costs


def _jax_ate(res, gt):
    return float(absolute_trajectory_error(
        jnp.asarray(res.camera_centers.astype(np.float32)),
        jnp.asarray(gt.astype(np.float32))))


@pytest.mark.parametrize("pm", [False, True])
def test_fused_steady_steps_bit_identical_to_staged(pan, staged, pm):
    """fused_steady_steps=True gives the staged loop's bits at seed 3
    (tests/test_incremental.py:234-250), with and without
    precompute_matching; the frames from the first steady frame on record
    ``pose_init="fused_step"`` and nothing else, as JAX's do."""
    cfg = dataclasses.replace(CFG, precompute_matching=pm,
                              fused_steady_steps=True)
    got = inc.run_incremental_sfm(pan["frames"], pan["k"], cfg, seed=3,
                                  device="cpu")
    _assert_same_run(staged(3, pm), got)
    kinds = [i["pose_init"] for i in got.frame_info]
    assert kinds == ["deferred", "deferred", "bootstrap"] + ["fused_step"] * 4
    assert all(set(i) == {"frame", "pose_init"} for i in got.frame_info[3:])


@pytest.mark.parametrize("seed", [0, 4])
def test_fused_scan_bit_identical_to_staged(pan, staged, seed):
    """run_incremental_sfm_fused gives the staged loop's bits at seeds 0
    and 4 (tests/test_incremental.py:195-215); its frames after the
    bootstrap are ``scan`` frames and the bootstrap's support is read at
    once."""
    got = run_incremental_sfm_fused(pan["frames"], pan["k"], CFG, seed=seed,
                                    device="cpu")
    _assert_same_run(staged(seed), got)
    ref = staged(seed).frame_info
    boot = next(i for i in got.frame_info if i["pose_init"] == "bootstrap")
    # JAX's keys: the staged frame's also holds its displacement read
    assert set(boot) == {"frame", "pose_init", "bootstrap_pair",
                         "bootstrap_support"}
    assert boot.items() <= next(
        i for i in ref if i["pose_init"] == "bootstrap").items()
    assert [i["pose_init"] for i in got.frame_info][boot["frame"]:] == \
        ["scan"] * (8 - 1 - boot["frame"])


def test_fused_refuses_a_mesh(pan):
    with pytest.raises(ValueError, match="single-device"):
        run_incremental_sfm_fused(pan["frames"], pan["k"],
                                  dataclasses.replace(CFG, mesh=object()),
                                  device="cpu")


def test_read_free_bootstraps_where_jax_does(pan, read_free):
    """read_free=True bootstraps at min(bootstrap_max_defer, F-1) with no
    displacement read (no ``bootstrap_disp_px``), as JAX's read_free run
    does, and both packages stay within tests/test_incremental.py:218-231's
    bounds."""
    ref = jinc.run_incremental_sfm(
        pan["frames"], pan["k"],
        jinc.SfmConfig(collect_diagnostics=False, read_free=True))
    expect = min(CFG.bootstrap_max_defer, len(pan["frames"]) - 1)
    for res in (read_free, ref):
        boot = [i for i in res.frame_info if i["pose_init"] == "bootstrap"]
        assert [i["frame"] for i in boot] == [expect]
        assert all("bootstrap_disp_px" not in i for i in res.frame_info)
        assert boot[0]["bootstrap_support"] > 0
        assert len(res.points) > 80
    assert trajectory_ate(read_free.rs, read_free.ts, pan["centers"]) < 0.2
    assert _jax_ate(ref, pan["centers"]) < 0.2


def test_export_false_round_trip(pan, read_free):
    """export=False returns the device-side handle with nothing read (the
    bootstrap support still a tensor, its info without
    ``bootstrap_support``); export_sfm_result gives the export=True run
    bit for bit, the support in its frame's info."""
    cfg = dataclasses.replace(CFG, read_free=True)
    dev = inc.run_incremental_sfm(pan["frames"], pan["k"], cfg, seed=0,
                                  export=False, device="cpu")
    assert isinstance(dev, inc.DeviceSfmResult)
    assert all(isinstance(x, torch.Tensor) for x in (dev.rs, dev.ts,
                                                     *dev.costs))
    info, support = dev.pending_support
    assert isinstance(support, torch.Tensor)
    assert "bootstrap_support" not in info
    got = inc.export_sfm_result(dev)
    assert isinstance(got, inc.SfmResult)
    _assert_same_run(read_free, got)
    assert info["bootstrap_support"] == int(support) > 0
    assert got.frame_info == read_free.frame_info


@pytest.mark.parametrize("change", [
    dict(read_free=False), dict(collect_diagnostics=True), "checkpoint"])
def test_export_false_preconditions(pan, tmp_path, change):
    """export=False needs read_free=True, collect_diagnostics=False and no
    checkpoint (JAX's stated preconditions): anything else raises before
    any work."""
    cfg = dataclasses.replace(CFG, read_free=True)
    kwargs = {}
    if change == "checkpoint":
        kwargs["checkpoint_path"] = str(tmp_path / "run.npz")
    else:
        cfg = dataclasses.replace(cfg, **change)
    with pytest.raises(ValueError, match="export=False"):
        inc.run_incremental_sfm(pan["frames"], pan["k"], cfg, export=False,
                                device="cpu", **kwargs)


def test_convert_carries_fused_and_read_free():
    """A JAX SfmConfig with both fields on carries across through
    convert.from_jax, and the port's defaults are JAX's."""
    d = dataclasses.asdict(jinc.SfmConfig(fused_steady_steps=True,
                                          read_free=True))
    _, _, cfg = from_jax(np.zeros((4, 2, 2), np.int32), np.eye(3), d,
                         device="cpu")
    assert cfg.fused_steady_steps is True and cfg.read_free is True
    assert cfg == dataclasses.replace(inc.SfmConfig(),
                                      fused_steady_steps=True,
                                      read_free=True)
    ref = jinc.SfmConfig()
    assert (inc.SfmConfig().fused_steady_steps, inc.SfmConfig().read_free) \
        == (ref.fused_steady_steps, ref.read_free) == (None, False)


def test_fused_run_beside_jax_fused(pan):
    """The port's fused run and the JAX package's fused_steady_steps=True
    run on the same frames both meet tests/test_incremental.py's bounds
    (ATE < 0.2, > 80 landmarks) and take the same frames through the
    step."""
    cfg = dataclasses.replace(CFG, fused_steady_steps=True)
    res = inc.run_incremental_sfm(pan["frames"], pan["k"], cfg, seed=0,
                                  device="cpu")
    ref = jinc.run_incremental_sfm(
        pan["frames"], pan["k"],
        jinc.SfmConfig(collect_diagnostics=False, fused_steady_steps=True))
    assert trajectory_ate(res.rs, res.ts, pan["centers"]) < 0.2
    assert _jax_ate(ref, pan["centers"]) < 0.2
    assert len(res.points) > 80 and len(ref.points) > 80
    assert [i["pose_init"] for i in res.frame_info].count("fused_step") \
        == [i["pose_init"] for i in ref.frame_info].count("fused_step") > 0


def test_fused_off_by_default(pan, staged):
    """fused_steady_steps=None (the default) runs the staged loop, as
    JAX's None resolves to off."""
    assert CFG.fused_steady_steps is None
    assert "fused_step" not in [i["pose_init"]
                                for i in staged(3).frame_info]


def test_row_helpers_device_index_equals_int():
    """take_row / put_row with a 0-dim index tensor give what an int index
    gives (the step's frame index lives on the device)."""
    x = torch.arange(24, dtype=torch.float32).reshape(4, 3, 2)
    v = -torch.ones(3, 2)
    for i in range(4):
        ti = torch.arange(4)[i]
        assert torch.equal(take_row(x, ti), x[i])
        assert torch.equal(take_row(x, ti), take_row(x, i))
        assert torch.equal(put_row(x, ti, v), put_row(x, i, v))
        assert torch.equal(put_row(x, ti, v)[i], v)
    assert torch.equal(x, torch.arange(24, dtype=torch.float32)
                       .reshape(4, 3, 2))


def test_graph_helpers_on_the_cpu():
    """sync_point outside a capture is the call itself; tree_map and
    tree_leaves walk NamedTuples, tuples, lists and None in order."""
    a = torch.tensor([[2.0, 1.0], [1.0, 3.0]])
    assert torch.equal(sync_point(torch.linalg.eigvalsh, a),
                       torch.linalg.eigvalsh(a))
    tree = (inc.TrackTable(*[torch.full((1,), float(i)) for i in range(7)]),
            [torch.zeros(2)], None)
    doubled = tree_map(lambda t: 2 * t, tree)
    assert isinstance(doubled[0], inc.TrackTable) and doubled[2] is None
    assert [float(t[0]) for t in tree_leaves(doubled)[:7]] == \
        [2.0 * i for i in range(7)]
    with pytest.raises(TypeError):
        tree_map(lambda t: t, {"a": a})
