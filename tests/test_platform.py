"""Where the program keeps its compile cache, how it refuses a mesh it
cannot have, and chip_smoke.py's refusal to report success off the GPU."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PRINT_CACHE = ("import jax, tpu_raytracer; "
                "print(jax.config.jax_compilation_cache_dir)")


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **extra)
    return env


def test_cache_defaults_to_checkout_root(tmp_path):
    out = subprocess.run([sys.executable, "-c", _PRINT_CACHE], env=_env(),
                         cwd=tmp_path, capture_output=True, text=True,
                         check=True).stdout.strip()
    assert out == os.path.join(REPO, ".jax_cache")


def test_cache_follows_environment(tmp_path):
    want = str(tmp_path / "cache")
    out = subprocess.run([sys.executable, "-c", _PRINT_CACHE],
                         env=_env(JAX_COMPILATION_CACHE_DIR=want),
                         cwd=tmp_path, capture_output=True, text=True,
                         check=True).stdout.strip()
    assert out == want


def test_tiles_beyond_device_count_raises():
    import jax

    from tpu_raytracer.app import interactive
    from tpu_raytracer.utils.config import parse_args

    n = len(jax.devices()) + 1
    with pytest.raises(ValueError, match=f"--tiles {n} needs {n} devices"):
        interactive.run(parse_args(["--scale=32x32", "--tiles", str(n),
                                    "--max-frames", "1", "--no-preview"]))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """On the CPU (and in a directory holding only the script) the smoke
    exits non-zero and never prints its ok line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    env = _env()
    if where == "alone":
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), tmp_path
        env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, script], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
