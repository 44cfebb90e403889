"""Native C-ABI shim: build with g++ and run the C smoke test in-process.

The shim (native/gooey_shim.cpp) embeds CPython and forwards the
`gooey_engine_*` C surface (include/gooey_tpu.h) to libgooey_tpu.capi —
the batched-engine equivalent of the reference's cdylib FFI (src/ffi.rs).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
BUILD = REPO / "native" / "build"


@pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("python3-config") is None,
    reason="native toolchain unavailable",
)
@pytest.mark.slow
def test_build_and_run_c_smoke():
    subprocess.run(
        ["sh", str(REPO / "native" / "build.sh")], check=True,
        capture_output=True, text=True,
    )
    env = dict(os.environ)
    env["LIBGOOEY_PLATFORM"] = "cpu"
    # CPU run — must use the machine-keyed CPU cache, never .jax_cache
    # (the accelerator cache), so foreign-host AOT entries are never loaded
    # and CPU entries never leak into the driver cache.
    from cache_dirs import cpu_cache_dir, pin_cpu_isa

    env["JAX_COMPILATION_CACHE_DIR"] = cpu_cache_dir()
    pin_cpu_isa(env)  # entries must match the conftest's portable-ISA pin
    # the embedded interpreter must resolve the same checkout
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [str(BUILD / "test_shim"), str(REPO)], env=env,
        capture_output=True, text=True, timeout=1500,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("OK"), proc.stdout
