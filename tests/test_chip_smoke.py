"""chip_smoke.py's contract where no GPU is present, and its pure
helpers (the kernel-vs-twin comparison and the result line)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PATH=os.path.dirname(sys.executable))  # no nvidia-smi
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_without_a_gpu():
    out = _run(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_result_line():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def _leaf_table():
    """A one-leaf WBVH8 table (num_internal=1, leaf_size=8) whose slots
    0 and 1 hold the same triangle, slot 2 one behind it."""
    k = 8
    tris = np.zeros((k, 3, 3), np.float32)
    base = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    tris[0] = tris[1] = base
    tris[2] = base + [0, 0, -1]
    comps = np.concatenate([tris[:, 0], tris[:, 1] - tris[:, 0],
                            tris[:, 2] - tris[:, 0]], axis=1)   # [8, 9]
    nodes = np.zeros((2, 72), np.float32)
    nodes[1] = comps.T.reshape(-1)
    return nodes


@pytest.mark.parametrize("case,ok", [
    ("same", True), ("tie", True), ("not_a_tie", False),
    ("hit_vs_miss", False), ("t_off", False), ("inactive_hit", False),
    ("too_many_ties", False)])
def test_compare_hits(case, ok):
    """20000 agreeing rays plus one ray that differs per `case`: one id
    mismatch in 20001 hits is within the agreement floor, so only
    whether it is a tie decides; ties past the floor fail even so."""
    nodes = _leaf_table()
    n = 20001
    o = np.tile([0.0, 0.0, 2.0], (n, 1))
    o[-1, 0] = 0.1
    d = np.tile([0.0, 0.0, -1.0], (n, 1))
    active = np.ones(n, bool)
    t_p = np.full(n, 2.0, np.float32)
    tri_p = np.zeros(n, np.int64)
    t_k, tri_k = t_p.copy(), tri_p.copy()
    if case == "tie":
        tri_k[-1] = 1      # the same triangle in another slot
    elif case == "not_a_tie":
        tri_k[-1] = 2      # a triangle 1 further away
    elif case == "hit_vs_miss":
        tri_k[-1] = -1
    elif case == "t_off":
        t_k[-1] = 2.001
    elif case == "too_many_ties":
        tri_k[:30] = 1     # 30 ties in 20001 hits: past the floor
    elif case == "inactive_hit":
        active[-1] = False
        tri_p[-1] = -1
    r = chip_smoke.compare_hits((t_p, tri_p), (t_k, tri_k), nodes, 1, 8,
                                o, d, active)
    assert r["ok"] is ok, r
