"""Process set-up shared by the drivers (utils/runtime.py): the compile
cache rule and the reading of nvidia-smi."""

import jax
import pytest

from sycl_ray_tracer_tpu.utils import runtime


def test_cache_dir_is_left_to_the_environment_variable():
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}
    assert runtime.compile_cache_dir(env) is None


@pytest.mark.parametrize("env", [{}, {"JAX_COMPILATION_CACHE_DIR": ""}])
def test_cache_dir_defaults_to_the_checkout(env):
    path = runtime.compile_cache_dir(env)
    assert path == runtime.CACHE_DIR
    assert path.endswith(".jax_cache")
    assert path.startswith(runtime.REPO_ROOT)


@pytest.mark.parametrize("set_var", [True, False])
def test_configure_sets_config_only_without_the_variable(monkeypatch,
                                                         set_var):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if set_var:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/tmp/x")
        assert runtime.configure_compile_cache() is None
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert runtime.configure_compile_cache() == runtime.CACHE_DIR
        assert calls == [("jax_compilation_cache_dir", runtime.CACHE_DIR)]


@pytest.mark.parametrize("text,cards", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 500.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W"),
      ("NVIDIA H100 80GB HBM3", "500.00 W")]),
    ("NVIDIA H100, NVL, [N/A]\n", [("NVIDIA H100, NVL", "[N/A]")]),
    ("", []),
    ("No devices were found\n", []),
])
def test_parse_nvidia_smi(text, cards):
    assert runtime.parse_nvidia_smi(text) == cards
