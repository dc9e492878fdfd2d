"""Process set-up shared by the entry points: compile cache, device checks.

Every entry point (`sim/run.py`, `bench.py`, `chip_smoke.py`, `tools/`)
calls `setup_compile_cache()` before its first compilation, and the
measurement paths call `require_gpu()`: a run that finds no GPU fails
instead of falling back to the CPU.
"""

from __future__ import annotations

import os
import subprocess

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, wins and no other directory is
    set here (JAX reads the variable itself); otherwise the cache lives
    in `<repo>/.jax_cache`. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def device_info() -> dict:
    """The device as JAX reports it."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info() -> str:
    """Card name and power limit as `nvidia-smi` reports them, one line
    per card joined by '; ' ("not available" without the tool)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return "not available"
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    return "; ".join(lines) if r.returncode == 0 and lines else "not available"


def require_gpu() -> None:
    """Exit non-zero unless JAX's default device is a GPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"no GPU found (JAX platform is {platform!r}); this path "
            "measures the GPU and does not fall back to the CPU"
        )
