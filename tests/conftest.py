"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device logic is tested the standard JAX way, with
`--xla_force_host_platform_device_count=8` on the CPU backend
(SURVEY.md §4.4). The platform is forced to the CPU through jax.config
before any backend init, whatever JAX_PLATFORMS says: the tests never
touch a GPU (chip_smoke.py is the on-card check).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
# On few-core hosts the 8 virtual device threads serialize, and XLA's
# default 40 s collective-rendezvous termination aborts the process when
# participants stagger. Give them an hour.
if "collective_call_terminate" not in flags:
    flags += (" --xla_cpu_collective_call_terminate_timeout_seconds=3600"
              " --xla_cpu_collective_call_warn_stuck_timeout_seconds=600")
os.environ["XLA_FLAGS"] = flags.strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture
def trace_env(monkeypatch):
    """setenv/delenv for TRACE-TIME env gates (TPU_RT_*).

    These gates are read inside jit-traced bodies, so they key NOTHING
    in the jit cache: flipping one without clearing the caches silently
    reuses the previously-compiled executable and the test compares an
    artifact against itself. Every change through this fixture clears
    the compilation caches to force a retrace."""
    class _TraceEnv:
        def setenv(self, name, value):
            monkeypatch.setenv(name, value)
            jax.clear_caches()

        def delenv(self, name, raising=True):
            monkeypatch.delenv(name, raising=raising)
            jax.clear_caches()

    yield _TraceEnv()
    jax.clear_caches()      # don't leak gated executables to later tests
