"""Test configuration: force CPU with a virtual 8-device mesh.

Tests run on CPU so they're hermetic and fast; the multi-device sharding
tests use 8 virtual host devices.  GPU execution is exercised by
chip_smoke.py, which needs a card.
"""

import os
import sys

_repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_repo_root, os.path.dirname(os.path.abspath(__file__))):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# The full suite JIT-compiles/loads hundreds of XLA:CPU executables in one
# process; each holds many code mappings, and the default vm.max_map_count
# (65530) exhausts ~94 tests in.  LLVM then fails mmap with "Cannot
# allocate memory" — a fatal abort on the cache-write (serialize/AOT) path
# and a SIGSEGV on the cache-read path.  Raise the limit when privileged;
# the test_examples cache-write guard remains as defense-in-depth.
try:
    with open("/proc/sys/vm/max_map_count") as _f:
        if int(_f.read()) < 1_000_000:
            with open("/proc/sys/vm/max_map_count", "w") as _f:
                _f.write("4194304")
except (OSError, ValueError):
    pass

# jax may already be imported with another platform list, in which case the
# env var is ignored — override through the config API as well (backend not
# yet initialized at conftest time).  XLA_FLAGS *is* still honored: it's read
# at backend initialization, which hasn't happened yet.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Pin XLA:CPU codegen to the portable ISA baseline (see cache_dirs.ISA_PIN):
# cached CPU executables must not carry host-specific AVX-512/AMX code that
# a migrated-to harness machine could mis-execute (r4's one-in-two-runs
# 5.8e5 state divergence in a fully deterministic seeded twin test).
from cache_dirs import pin_cpu_isa  # noqa: E402

pin_cpu_isa()

# XLA:CPU compiles are ~0.4 s per distinct op in this image; persist them.
# MUST be (a) a dir separate from the accelerator cache (.jax_cache) and
# (b) keyed by the host CPU fingerprint: XLA:CPU cache entries are AOT host
# binaries whose key ignores CPU features, and this harness migrates between
# machine types mid-round.  Loading a foreign entry (e.g. compiled with
# +prefer-no-scatter/+amx) executes mismatched machine code — observed as
# SIGABRT mid-suite and ~1e-4 numeric drift vs native compiles.  Env vars
# are ignored here (jax pre-imported) — only the config API takes effect.
from cache_dirs import cpu_cache_dir  # noqa: E402

_cache = cpu_cache_dir()
os.environ["JAX_COMPILATION_CACHE_DIR"] = _cache
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", _cache)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
