"""Process set-up shared by the command-line drivers."""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# One fixed path inside the checkout: the path is part of what a cache
# entry is found by, so a directory that moved would never hit.
CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir(environ=None) -> str | None:
    """Where the drivers ask JAX to keep compiled programs: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself and nothing
    here overrides it), else <repo>/.jax_cache."""
    environ = os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def configure_compile_cache() -> str | None:
    """Apply compile_cache_dir() to jax.config; returns the directory
    set, or None where the environment variable decides."""
    path = compile_cache_dir()
    if path is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """(name, power limit) per card from the output of
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if sep and name.strip():
            cards.append((name.strip(), limit.strip()))
    return cards


def gpu_cards() -> list[tuple[str, str]]:
    """(name, power limit) of every NVIDIA card, read by nvidia-smi in a
    child process (which never touches JAX); [] where there is none."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return parse_nvidia_smi(out.stdout) if out.returncode == 0 else []
