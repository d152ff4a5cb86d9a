"""chip_smoke.py plumbing on the CPU.

The script measures only on a GPU; here its gates, its oracle, its
refusal to run without a card and the shape of its last line are
checked, and phases (c) and (d) run at 32x32 on CPU devices.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from radiance_tpu.ops.intersect import FLT_MAX  # noqa: E402
from radiance_tpu.scene import bench_scenes  # noqa: E402


def _run(args, cwd, script=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script or os.path.join(REPO, "chip_smoke.py"),
         *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def _no_result_line(out):
    return not any(line.startswith("{") for line in out.stdout.splitlines())


def test_refuses_cpu(tmp_path):
    out = _run([], tmp_path)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert _no_result_line(out)


def test_fails_alone_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run([], tmp_path, script=str(tmp_path / "chip_smoke.py"))
    assert out.returncode != 0
    assert _no_result_line(out)


def test_bench_refuses_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "bench.py"),
                          "--engine"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("mode", ["--multi", "--tbound", "--ab"])
def test_removed_modes_are_refused_by_name(mode, tmp_path, capsys):
    """Modes of the removed kernel stack and its A/B are not silently
    ignored: bench.py names them and exits non-zero before touching a
    device; chip_smoke.py rejects them as unknown options."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "bench.py"),
                          mode], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert f"unknown mode {mode}" in out.stderr
    assert out.stdout.strip() == ""
    if mode == "--multi":       # still a chip_smoke option
        return
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([mode])
    assert e.value.code != 0
    assert mode in capsys.readouterr().err


def _clean():
    rng = np.random.default_rng(0)
    t = rng.uniform(1, 100, 1000).astype(np.float32)
    t[::5] = FLT_MAX
    prim = rng.integers(0, 5000, 1000)
    return t, prim


def _plant(kind):
    t_ref, prim_ref = _clean()
    t, prim = t_ref.copy(), prim_ref.copy()
    if kind == "hit_flip":
        t[1:30:3] = FLT_MAX                   # 10 real hits dropped
    elif kind == "t_drift":
        t[np.arange(1000) % 5 != 0] *= 1.001  # every hit 1e-3 too far
    elif kind == "prim_swap":
        prim[1:40:3] += 1                     # 13 wrong primitives
    return chip_smoke.compare(t, prim, t_ref, prim_ref)


@pytest.mark.parametrize("kind", ["hit_flip", "t_drift", "prim_swap"])
def test_gate_flags_planted_disagreement(kind):
    fails = chip_smoke.gate_failures(_plant(kind))
    assert fails, f"planted {kind} passed the gate"


def test_gate_passes_agreement_and_ignores_t_for_any_hit():
    st = _plant("none")
    assert st["hit_agree"] == 1.0 and st["prim_match"] == 1.0
    assert chip_smoke.gate_failures(st) == []
    assert chip_smoke.gate_failures(_plant("t_drift"), any_hit=True) == []


def test_brute_force_chunks_match_one_pass():
    from radiance_tpu.ops.intersect import intersect_triangle_soup
    verts, tris = bench_scenes.city_geometry(1000, n_clusters=4)
    tv = verts[tris.astype(np.int64)]
    v0, e1, e2 = (jnp.asarray(x) for x in (
        tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))
    o, d = (jnp.asarray(x) for x in bench_scenes.camera_rays(
        "city", 16, 16))
    t, i = chip_smoke.brute_force(o, d, v0, e1, e2, 1e-3, 1e4, chunk=96)
    t1, i1, _, _ = intersect_triangle_soup(o, d, v0, e1, e2, 1e-3, 1e4)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(t1))
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i1))


def test_oracle_subset_spreads_over_live_lanes():
    live = np.zeros(10000, bool)
    live[5000:5100] = True
    idx = chip_smoke.oracle_subset(10000, live, k=64)
    assert idx.min() == 0 and idx.max() == 9999
    assert live[idx].sum() >= 64


def test_phase_traversal_at_32():
    verts, tris = bench_scenes.scene_geometry("interior", 3000)
    scene, _ = bench_scenes.build_scene(verts, tris)
    res = chip_smoke.phase_traversal(scene, verts, tris, 32, 32, k=256,
                                     kind="interior")
    assert set(res) == {"primary", "shadow", "bounce"}
    for st in res.values():
        assert st["hit_frac"] > 0.5 and st["hit_agree"] >= 0.999


def test_phase_engine_at_32():
    out = chip_smoke.phase_engine(32)
    assert out[1]["rmse"] < chip_smoke.RMSE_ONE_BOUNCE
    assert out[2]["rmse"] < chip_smoke.RMSE_GI


def test_last_line_shape(monkeypatch, capsys):
    dev = types.SimpleNamespace(platform="gpu", device_kind="Fake H100")
    monkeypatch.setattr(chip_smoke, "require_gpu", lambda: dev)
    monkeypatch.setattr(chip_smoke, "card_line",
                        lambda: "Fake H100, 700.00 W")
    calls = []
    monkeypatch.setattr(chip_smoke, "phase_scene",
                        lambda n: (calls.append("b") or (None, None, None)))
    for name in ("phase_traversal", "phase_frame", "phase_multi"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    monkeypatch.setattr(chip_smoke, "phase_engine",
                        lambda size: calls.append("engine"))
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "Fake H100, 700.00 W"
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {
        "platform": "gpu", "kind": "Fake H100", "count": last["device"][
            "count"]}}
    assert isinstance(last["device"]["count"], int)
    assert calls == ["b", "phase_traversal", "engine", "phase_frame"]
    calls.clear()
    assert chip_smoke.main(["--multi"]) == 0
    assert calls == ["b", "phase_multi"]
