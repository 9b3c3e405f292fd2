"""The renderer on the device against a frozen copy of the port's NumPy
renderer, at 240x320: the same frames, pixel for pixel."""
import _paths  # noqa: F401
import numpy as np
import pytest
import torch

import numpy_scene as ref
from harness import scene


@pytest.mark.parametrize("dot_seed,texture_seed,frames", [
    (7, 0.0, (0, 5, 11)),          # the original's scene
    (123456789, 4321.0, (0, 2)),   # a scene drawn for a run
])
def test_frames_equal_numpy_renderer(dot_seed, texture_seed, frames):
    torch.set_num_threads(1)
    spec = scene.SceneSpec(image_size=(240, 320), focal=130.0,
                           dot_seed=dot_seed, texture_seed=texture_seed)
    cfg = ref.StarSceneConfig(image_size=(240, 320), focal=130.0,
                              dot_seed=dot_seed, texture_seed=texture_seed)
    got = scene.render_frames(spec, frames, torch.device("cpu")).numpy()
    rs, ts, centers = ref.pan_trajectory(cfg)
    k = ref.intrinsics(cfg)
    want = np.stack([ref.render_frame(cfg, rs[i], ts[i], k) for i in frames])
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    r2, t2, c2 = scene.pan_trajectory(spec)
    np.testing.assert_array_equal(r2, rs)
    np.testing.assert_array_equal(c2, centers)
    np.testing.assert_array_equal(scene.intrinsics(spec), k)


def test_scene_seeds_take_any_seed():
    a = scene.scene_seeds(2 ** 31 + 5, 3)
    assert a == scene.scene_seeds(2 ** 31 + 5, 3)
    assert a != scene.scene_seeds(2 ** 31 + 5, 4)
    assert scene.scene_seeds(-1, 0) != a
