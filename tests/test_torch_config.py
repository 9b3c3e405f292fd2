"""Port parity: ``config.py``'s layered configuration against the JAX
package's ``config.py``: the same file and environment overlay give the
same values field for field (the frontend's without JAX's two
``use_pallas_*`` flags), and the same inputs raise the same ValueError;
an unknown frontend reduction raises at load here (the port's
FrontendConfig checks it when it is made)."""
import dataclasses
import json

import pytest

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu import config as jcfg
from photogrammetry_tpu_torch import config as cfg
from photogrammetry_tpu_torch.convert import JAX_ONLY_KEYS

BASE = {"dewarp": {"height": 480, "width": 640,
                   "coefficients": [1e-4, 2e-7, 0, 0, 0]},
        "camera": {"fx": 520.0, "fy": 521.0},
        "frontend": {"max_keypoints": 512, "cluster_chunks": [2, 2]},
        "ba": {"iterations": 12}}
OVERLAY = {"ransac": {"num_samples": 500, "threshold": 2.0},
           "camera": {"cx": 320.0}, "frontend": {"reduction": "anms"}}


def _fields(c) -> dict:
    d = dataclasses.asdict(c)
    d["frontend"] = {k: v for k, v in d["frontend"].items()
                     if k not in JAX_ONLY_KEYS}
    return d


def _write(tmp_path, name, obj):
    path = tmp_path / name
    path.write_text(json.dumps(obj))
    return str(path)


def test_defaults_equal_jax():
    assert _fields(cfg.load_config()) == _fields(jcfg.load_config())
    assert cfg.ENV_VAR == jcfg.ENV_VAR


@pytest.mark.parametrize("env", [None, "staging", "absent"])
def test_file_and_environment_overlay_equal_jax(tmp_path, monkeypatch, env):
    path = _write(tmp_path, "settings.json", BASE)
    _write(tmp_path, "settings.staging.json", OVERLAY)
    if env is None:
        monkeypatch.delenv(cfg.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(cfg.ENV_VAR, env)
    got, ref = cfg.load_config(path), jcfg.load_config(path)
    assert _fields(got) == _fields(ref)
    assert got.frontend.cluster_chunks == (2, 2)
    assert got.dewarp.coefficients == (1e-4, 2e-7, 0, 0, 0)
    assert (got.ransac.num_samples == 500) == (env == "staging")
    # the explicit argument wins over the environment
    monkeypatch.setenv(cfg.ENV_VAR, "absent")
    assert _fields(cfg.load_config(path, environment="staging")) == \
        _fields(jcfg.load_config(path, environment="staging"))


@pytest.mark.parametrize("bad", [
    {"dewarp": {"coefficients": [1, 2, 3]}},
    {"dewarp": {"width": 0}},
    {"camera": {"fx": -1.0}},
    {"ransac": {"sample_size": 7}},
    {"ransac": {"num_samples": 0}},
    {"ba": {"window": 0}},
    {"nonsense": 1},
    {"ba": {"iterations": 5, "bogus": True}},
])
def test_invalid_config_raises_as_jax(tmp_path, bad):
    path = _write(tmp_path, "bad.json", bad)
    with pytest.raises(ValueError) as ref:
        jcfg.load_config(path)
    with pytest.raises(ValueError) as got:
        cfg.load_config(path)
    assert str(got.value) == str(ref.value)


def test_unknown_reduction_fails_at_load(tmp_path):
    """The port's FrontendConfig checks its reduction when it is made, so
    load_config fails fast where JAX's loads and fails at first use."""
    path = _write(tmp_path, "bad.json", {"frontend": {"reduction": "x"}})
    assert jcfg.load_config(path).frontend.reduction == "x"
    with pytest.raises(ValueError, match="unknown reduction 'x'"):
        cfg.load_config(path)
