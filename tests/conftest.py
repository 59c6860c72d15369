"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Selection policy: compile-heavy tests (full-pipeline / scanner / stream
programs, minutes of cold XLA compile each) carry ``@pytest.mark.slow``.
``pytest tests/ -m "not slow"`` is the quick gate; the FULL suite is the
pre-merge bar. A persistent compile cache is used only where
``JAX_COMPILATION_CACHE_DIR`` names one: the suite writes nothing into the
checkout.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import jax

jax.config.update("jax_platforms", "cpu")

assert jax.default_backend() == "cpu", f"tests must run on CPU, got {jax.default_backend()}"
assert len(jax.devices()) >= 8, "virtual 8-device CPU mesh not active"
