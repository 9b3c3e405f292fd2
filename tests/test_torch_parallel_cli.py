"""The port's distributed CLIs on the CPU: ``run_sfm --mesh`` (gloo ranks
spawned by the CLI) beside the unmeshed run at
tests/test_run_sfm_cli.py::test_run_sfm_mesh_matches_single_device's size,
and ``bench_scaling --force-cpu``.

As the JAX test argues, the sharded BA is float-equivalent to the single
one (tests/test_torch_parallel.py) but its last-bit differences cross the
pipeline's RANSAC and pruning gates, so the whole-run oracle is equal
quality: ATE within 0.1 of the unmeshed run's.  A world of one rank sums
nothing across ranks, so ``--mesh 1`` gives the unmeshed run's bits.
"""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu_torch.cli import bench_scaling, run_sfm
from photogrammetry_tpu_torch.sfm.metrics import absolute_trajectory_error
from photogrammetry_tpu_torch.synth.star_scene import (
    StarSceneConfig, generate_sequence,
)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    scene = generate_sequence(StarSceneConfig(
        num_frames=5, image_size=(240, 320), focal=260.0, supersample=2))
    frames_dir = tmp_path_factory.mktemp("frames")
    for i, frame in enumerate(scene["frames"]):
        Image.fromarray(frame).save(frames_dir / f"{i:03d}.png")
    return frames_dir, scene["centers"]


@pytest.fixture(scope="module")
def runs(scene_dir, tmp_path_factory):
    """run_sfm unmeshed, at --mesh 1 and at --mesh 2 (--device cpu): each
    run's trajectory and whether it wrote its cloud."""
    frames_dir, centers = scene_dir
    out = tmp_path_factory.mktemp("runs")
    res = {}
    for name, extra in (("single", []), ("mesh1", ["--mesh", "1"]),
                        ("mesh2", ["--mesh", "2"])):
        traj, cloud = out / f"traj_{name}.json", out / f"cloud_{name}.ply"
        assert run_sfm.main([str(frames_dir), "--device", "cpu",
                             "--fx", "260", "--cx", "160", "--cy", "120",
                             "--detection-threshold", "20",
                             "--trajectory", str(traj),
                             "--cloud", str(cloud)] + extra) == 0
        c = np.asarray(json.loads(traj.read_text())["centers"])
        res[name] = dict(traj=json.loads(traj.read_text()),
                         cloud=cloud.read_text(),
                         ate=float(absolute_trajectory_error(
                             torch.tensor(c), torch.tensor(
                                 centers, dtype=torch.float64))))
    return res


def test_run_sfm_mesh_matches_unmeshed_run(runs):
    ates = {name: r["ate"] for name, r in runs.items()}
    assert ates["mesh2"] < 0.8, ates
    assert abs(ates["mesh2"] - ates["single"]) < 0.1, ates
    assert len(runs["mesh2"]["traj"]["centers"]) == 5
    assert runs["mesh2"]["cloud"].startswith("ply")


def test_run_sfm_mesh_of_one_rank_is_the_unmeshed_run(runs):
    assert runs["mesh1"]["traj"] == runs["single"]["traj"]
    assert runs["mesh1"]["cloud"] == runs["single"]["cloud"]


def test_run_sfm_mesh_refuses_a_shared_checkpoint(tmp_path):
    with pytest.raises(SystemExit):
        run_sfm.main(["--device", "cpu", "--mesh", "2", "--checkpoint",
                      str(tmp_path / "run.npz")])


def test_bench_scaling_force_cpu_records(tmp_path, capsys):
    stats = tmp_path / "scaling.json"
    assert bench_scaling.main([
        "--force-cpu", "--devices", "1", "2", "--frames", "4",
        "--tracks-per-device", "64", "--iterations", "2", "--repeats", "1",
        "--stats", str(stats)]) == 0
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    logged = json.loads(stats.read_text())
    assert [r["mesh_devices"] for r in printed] == [1, 2]
    assert [r["tracks"] for r in printed] == [64, 128]
    for rec in printed:
        assert rec["metric"] == "ba_iters_per_s"
        assert rec["mode"] == "weak" and rec["unit"] == "iters/s"
        assert rec["platform"] == "cpu" and rec["value"] > 0
        assert rec["frames"] == 4 and "hostname" in rec
    assert printed[0]["scaling_efficiency"] == 1.0
    assert [{k: r[k] for k in printed[0]} for r in logged] == printed


def test_distributed_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from photogrammetry_tpu_torch.parallel import make_mesh
    from photogrammetry_tpu_torch.parallel.multihost import make_pod_mesh

    for call in (make_mesh, make_pod_mesh,
                 lambda: bench_scaling.main(["--devices", "1"]),
                 lambda: run_sfm.main(["--mesh", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
