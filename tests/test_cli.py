"""CLI end-to-end smoke (subprocess, CPU backend) + stdout contract."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if "xla_force_host_platform_device_count" not in env.get("XLA_FLAGS", ""):
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            " --xla_force_host_platform_device_count=8").strip()
    return subprocess.run(
        [sys.executable, "-m", "sycl_ray_tracer_tpu"] + args,
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)


def test_cli_renders_and_prints_contract(tmp_path):
    out_png = tmp_path / "out.png"
    r = _run(["triangle", "-m", "-s", "2", "-d", "3",
              "--width", "64", "--height", "48", "-o", str(out_png)])
    assert r.returncode == 0, r.stderr[-2000:]
    # the three benchmark-scraped lines (render_megakernel.cpp:181-183)
    assert re.search(r"Time measured: [0-9.]+ seconds", r.stdout)
    assert re.search(r"Total rays: [0-9]+", r.stdout)
    assert re.search(r"Rays/sec: [0-9.]+M", r.stdout)
    assert out_png.exists() and out_png.stat().st_size > 100


def test_cli_missing_scene_is_clean():
    r = _run(["/does/not/exist.glb"])
    assert r.returncode != 0
    assert "scene not found" in (r.stdout + r.stderr)


def test_cli_rr_with_devices(tmp_path):
    # regression: --rr used to crash under --devices > 1 because
    # render_sharded had no rr parameter
    out_png = tmp_path / "out.png"
    r = _run(["triangle", "--rr", "--devices", "2", "-s", "2", "-d", "3",
              "--width", "32", "--height", "32", "-o", str(out_png)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert out_png.exists()


def test_cli_default_scene_falls_back_to_procedural(tmp_path):
    # bare invocation must work out of the box: the default
    # ./assets/sponza.glb doesn't exist (reference gitignores it), so
    # the CLI substitutes the procedural stand-in
    out_png = tmp_path / "out.png"
    r = _run(["-s", "1", "-d", "2", "--width", "32", "--height", "32",
              "-o", str(out_png)], timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "sponza_proc" in r.stdout
    assert out_png.exists()


def test_cli_bad_devices_divisor():
    r = _run(["triangle", "--devices", "3", "-s", "8", "-d", "2",
              "--width", "32", "--height", "32"])
    assert r.returncode != 0
    assert "must divide" in (r.stdout + r.stderr)
