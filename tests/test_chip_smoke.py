"""chip_smoke.py's contract (device check, result line), the compile
cache location, and — on a card only — its phases as tests."""

import json
import os
import sys
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from ndt_feature_graph_tpu.utils import compile_cache  # noqa: E402


def test_refuses_cpu_platform(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_result_line_shape():
    dev = types.SimpleNamespace(
        platform="gpu", device_kind="NVIDIA H100 80GB HBM3"
    )
    line = chip_smoke.result_line([dev])
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
        },
    }


@pytest.mark.parametrize("env_dir", [None, "cache-from-env"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.cache_dir()
        assert path == os.path.join(REPO, ".jax_cache")
        assert os.path.commonpath([path, REPO]) == REPO
        assert path == compile_cache.cache_dir()    # fixed, not per run
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        assert compile_cache.cache_dir() == want


@pytest.mark.gpu
@pytest.mark.parametrize(
    "phase",
    [
        chip_smoke.phase_registration,
        chip_smoke.phase_online,
        chip_smoke.phase_fleet,
        chip_smoke.phase_solve,
    ],
    ids=lambda f: f.__name__,
)
def test_phase_on_card(gpu_devices, phase):
    chk = chip_smoke.Check()
    phase(chk)
    assert chk.ok, chk.text()
