"""The device check of the GPU scripts and the compile-cache location."""

import os

import jax
import pytest

import cache_dirs
import bench
import chip_smoke

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("check", [
    lambda: bench.require_gpu(jax), lambda: chip_smoke.main([])],
    ids=["require_gpu", "chip_smoke_main"])
def test_device_check_raises_without_a_gpu(check, capsys):
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        check()
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/cache/from/env"}, "/cache/from/env"),
    ({}, os.path.join(_REPO, ".jax_cache")),
], ids=["variable_set", "variable_unset"])
def test_compile_cache_dir(env, want):
    assert cache_dirs.compile_cache_dir(env) == want
