"""Auxiliary subsystems: checkpoint/resume, viz export, config, CLI."""

import json
import os

import numpy as np
import pytest

from rfx.config import CoverageConfig, TraceConfig, resolve_scene
from rfx.utils.checkpoint import ChunkAccumulator, run_chunked
from rfx.viz import scene_to_html


def test_chunk_accumulator_resume(tmp_path):
    d = str(tmp_path / "acc")
    calls = []

    def chunk(cid):
        calls.append(cid)
        return {"ir": np.full(4, float(cid + 1))}

    out = run_chunked(chunk, 3, d)
    assert np.allclose(out["ir"], 1 + 2 + 3)
    assert calls == [0, 1, 2]

    # Resume: nothing re-runs, result intact
    calls.clear()
    out2 = run_chunked(chunk, 3, d)
    assert calls == []
    assert np.allclose(out2["ir"], 6)

    # Extend: only the new chunk runs
    out3 = run_chunked(chunk, 4, d)
    assert calls == [3]
    assert np.allclose(out3["ir"], 10)


def test_chunk_accumulator_idempotent_add(tmp_path):
    acc = ChunkAccumulator(str(tmp_path / "a"))
    acc.add(0, {"x": np.ones(2)})
    acc.add(0, {"x": np.ones(2) * 100})  # ignored: already done
    assert np.allclose(acc.result()["x"], 1.0)
    # Fresh instance reloads from disk
    acc2 = ChunkAccumulator(str(tmp_path / "a"))
    assert acc2.done_chunks == {0}
    assert np.allclose(acc2.result()["x"], 1.0)


def test_scene_html_contains_geometry(box_room):
    paths = [np.asarray([[0, 0, 2], [5, 5, 2]], np.float32)]
    pairs = [(np.asarray([1.0, 2.0, 3.0]), (10, 200, 30))]
    html = scene_to_html(
        mesh=box_room, tx_pos=[0, 0, 2], rx_pos=[5, 5, 2], rx_radius=0.5,
        paths=paths, point_color_pairs=pairs,
    )
    assert "THREE" in html or "three" in html
    assert '"mesh"' in html and '"faces"' in html
    assert '"paths"' in html and '"colored_points"' in html
    # Embedded JSON parses back
    start = html.index("const SCENE = ") + len("const SCENE = ")
    end = html.index(";\n", start)
    payload = json.loads(html[start:end])
    assert len(payload["mesh"]["vertices"]) == box_room.num_vertices
    assert payload["rx_radius"] == 0.5


def test_config_roundtrip_and_grid():
    cfg = CoverageConfig(scene="room", num_rays=1000)
    cfg2 = CoverageConfig.from_json(cfg.to_json())
    assert cfg2 == cfg
    grid = cfg.grid_points()
    # Reference sweep: 16 x 16 x 8 = 2048 points (ref coverage.py:38-40)
    assert grid.shape == (2048, 3)
    assert grid.min() == -15.0 and grid.max() == 15.0


def test_resolve_scene_named_and_path(tmp_path):
    m = resolve_scene("room")
    assert m.num_faces > 0
    with pytest.raises((OSError, ValueError)):
        resolve_scene(str(tmp_path / "missing.stl"))


def test_cli_cir_smoke(tmp_path, capsys):
    from rfx.cli import main

    out = str(tmp_path / "scene.html")
    rc = main([
        "cir", "--scene", "room", "--rays", "2000", "--bounces", "2",
        "--tx", "5", "5", "2", "--rx", "-5", "-5", "2", "--rx-radius", "1.5",
        "--out", out,
    ])
    assert rc == 0
    assert os.path.exists(out)
    text = capsys.readouterr().out
    assert "RX power" in text


def test_phase_timer_and_throughput():
    import time as _time

    import jax.numpy as jnp

    from rfx.utils.profiling import PhaseTimer, Throughput

    t = PhaseTimer()
    x = jnp.ones((16,))
    with t.phase("a", block_on=x * 2):
        _time.sleep(0.01)
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    assert t.totals["a"] >= 0.01
    rep = t.report()
    assert "a:" in rep and "x2" in rep

    tp = Throughput()
    with tp.measure(1000) as holder:
        holder["result"] = x + 1
    assert tp.rays == 1000
    assert tp.seconds > 0 and tp.mrays_per_s > 0


def test_cli_cir_chunked_resume(tmp_path, capsys):
    """--chunks N accumulates partial IRs with checkpointed resume: a second
    run re-reads the chunk state and recomputes nothing."""
    import json as _json

    from rfx.cli import main

    out = str(tmp_path / "scene.html")
    resume = str(tmp_path / "chunks")
    argv = [
        "cir", "--scene", "room", "--rays", "2048", "--bounces", "2",
        "--tx", "5", "5", "2", "--rx", "-5", "-5", "2", "--rx-radius", "1.5",
        "--out", out, "--chunks", "2", "--resume-dir", resume,
    ]
    rc = main(argv)
    assert rc == 0
    meta = _json.load(open(os.path.join(resume, "meta.json")))
    assert meta["done"] == [0, 1]
    first = capsys.readouterr().out
    assert "RX power" in first

    # resume: both chunks already done -> same dBm, no recompute
    rc = main(argv)
    assert rc == 0
    second = capsys.readouterr().out
    # paths differ (resume recomputes nothing, so none are recorded); the
    # accumulated IR — and hence the dBm — must be identical.
    dbm1 = [l.split("RX power:")[1] for l in first.splitlines() if "RX power" in l]
    dbm2 = [l.split("RX power:")[1] for l in second.splitlines() if "RX power" in l]
    assert dbm1 == dbm2


def test_cli_cir_profile_report(tmp_path, capsys):
    from rfx.cli import main

    out = str(tmp_path / "scene.html")
    prof = str(tmp_path / "prof")
    rc = main([
        "cir", "--scene", "room", "--rays", "1024", "--bounces", "1",
        "--tx", "5", "5", "2", "--rx", "-5", "-5", "2", "--rx-radius", "1.5",
        "--out", out, "--profile", prof,
    ])
    assert rc == 0
    text = capsys.readouterr().out
    assert "profiler trace written" in text
    assert "trace:" in text  # PhaseTimer report
    assert os.path.isdir(prof) and os.listdir(prof)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir_rule(env_set, monkeypatch, tmp_path):
    """$JAX_COMPILATION_CACHE_DIR wins and nothing else is set; otherwise a
    fixed, git-ignored directory inside the checkout."""
    import jax

    from rfx.utils import cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    if env_set:
        monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path))
        assert cache.enable_compile_cache() == str(tmp_path)
        assert calls == []
    else:
        monkeypatch.delenv(cache.CACHE_ENV, raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        want = os.path.join(root, ".jax_cache")
        assert cache.enable_compile_cache() == want == cache.compile_cache_dir()
        assert calls == [("jax_compilation_cache_dir", want)]
        assert ".jax_cache/" in open(os.path.join(root, ".gitignore")).read().split()


def test_cli_coverage_without_matplotlib(tmp_path, monkeypatch, capsys):
    """`rfx.cli coverage --no-viz` needs no matplotlib (absent on some hosts)."""
    import sys

    from rfx.cli import main

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises
    cfg = CoverageConfig(num_rays=2000, grid_x=(-10.0, 10.0, 10.0),
                         grid_y=(-10.0, 10.0, 10.0), grid_z=(2.0, 8.0, 6.0))
    path = tmp_path / "cov.json"
    path.write_text(cfg.to_json())
    out = tmp_path / "dbm.npy"
    rc = main(["coverage", "--config", str(path), "--no-viz", "--save-dbm", str(out)])
    assert rc == 0
    arr = np.load(out)
    assert arr.shape == (18, 4) and np.isfinite(arr[:, 3]).any()
    assert "receivers reached" in capsys.readouterr().out


def test_dbm_colors_ramp():
    from rfx.cli import dbm_colors

    c = dbm_colors(np.array([-np.inf, -130.0, -100.0, -70.0, 0.0]), -130.0, -70.0)
    assert c.shape == (5, 3) and c.dtype.kind == "i"
    np.testing.assert_array_equal(c[0], c[1])  # nothing received -> low end
    np.testing.assert_array_equal(c[1], [68, 1, 84])
    np.testing.assert_array_equal(c[3], c[4])  # clipped at the top
    np.testing.assert_array_equal(c[3], [253, 231, 37])
