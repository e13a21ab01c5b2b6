"""The GPU smoke run's CPU-side contract and the compile-cache location."""

import importlib.util
import json
import os
from types import SimpleNamespace

import jax
import pytest

from particlerobotsimulations_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("count", [1, 4])
def test_result_line(count):
    """The last line is exactly the contract's JSON object, with the device
    as JAX reports it."""
    cs = load_chip_smoke()
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
            for _ in range(count)]
    line = cs.result_line(devs)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        f'"kind": "NVIDIA H100 80GB HBM3", "count": {count}}}}}'
    )
    assert json.loads(line)["device"]["count"] == count


def test_chip_smoke_refuses_cpu(capsys):
    """Without a GPU the smoke run exits non-zero before any phase and
    prints no result line."""
    cs = load_chip_smoke()
    assert jax.devices()[0].platform == "cpu"
    rc = cs.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok"' not in out
    assert "[b]" not in out


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    the cache sits at <repo>/.jax_cache (a fixed path: it is part of every
    cache entry's key)."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
        assert compile_cache.enable_compile_cache() == want
        assert calls == [("jax_compilation_cache_dir", want)]
