"""Mechanics of chip_smoke.py and bench.py on the CPU: refusal off the GPU,
the seeded input, each phase at a tiny size, option handling, and the
nvidia-smi reader."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import bench
import chip_smoke
from csdr_tpu.utils import testsig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_main_refuses_cpu_without_ok_line(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails_without_ok_line(tmp_path):
    """chip_smoke.py copied into a directory that holds nothing else of the
    repository fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=_cpu_env(),
                       timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_seeded_capture_is_reproducible():
    a, ka = testsig.fm_channel_capture(4096, 64, seed=7)
    b, kb = testsig.fm_channel_capture(4096, 64, seed=7)
    c, _ = testsig.fm_channel_capture(4096, 64, seed=8)
    assert ka == kb and len(ka) == 8
    assert a.dtype == np.complex64 and np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.max(np.abs(a)) < 1.0          # fits the cu8 wire unclipped
    assert np.array_equal(testsig.to_cu8(a), testsig.to_cu8(b))


@pytest.mark.parametrize("wire", ["cf32", "cu8"])
def test_phase_flagship_tiny(tmp_path, wire):
    r = chip_smoke.phase_flagship(str(tmp_path), wire, n=64 * 1024,
                                  block=64 * 256)
    assert r["min_signal_snr_db"] > chip_smoke.SNR_FLOOR_DB
    assert len(r["signal_snr_db"]) == 8


def test_phase_wbfm_tiny(tmp_path):
    r = chip_smoke.phase_wbfm(str(tmp_path), n=1 << 18, block=1 << 16)
    assert r["snr_db"] > chip_smoke.WBFM_FLOOR_DB


def test_phase_mesh_on_four_virtual_devices(tmp_path):
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    r = chip_smoke.phase_mesh(str(tmp_path), n=64 * 2048, block=64 * 512)
    for shape in chip_smoke.MESH_SHAPES:
        assert r[shape]["devices"] == 4
        assert r[shape]["vs_float64"]["min_signal_snr_db"] > \
            chip_smoke.SNR_FLOOR_DB


def test_multi_selects_only_the_mesh_phase():
    _, phases = chip_smoke.plan(["--multi"])
    assert phases == ["mesh"]
    _, phases = chip_smoke.plan([])
    assert "mesh" not in phases
    assert set(phases) == {"timing", "tests", "flagship", "wbfm"}


def test_bench_exits_nonzero_on_cpu():
    p = subprocess.run([sys.executable, "bench.py", "--iters", "1"],
                       cwd=REPO, capture_output=True, text=True,
                       env=_cpu_env(), timeout=300)
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    assert "msps" not in p.stdout


def test_bench_flagship_step_mechanics():
    """The timing function itself at a tiny size (the CPU's time says
    nothing of the card; this checks the fields and the carried state)."""
    for wire in ("cf32", "cu8"):
        r = bench.flagship_step(wire, block=64 * 64, iters=2, nch=64)
        assert r["msps"] > 0 and r["compile_s"] > 0
        assert r["memory_analysis"]["argument_size_in_bytes"] > 0


def test_nvidia_smi_parser():
    text = ("NVIDIA H100 80GB HBM3, 700.00 W\n"
            "NVIDIA H100 80GB HBM3, 700.00 W\n")
    assert bench.parse_nvidia_smi(text) == ["NVIDIA H100 80GB HBM3, 700.00 W"] * 2
    with pytest.raises(ValueError):
        bench.parse_nvidia_smi("")
    with pytest.raises(ValueError):
        bench.parse_nvidia_smi("garbage without fields\n")


def test_nvidia_smi_missing_raises(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvidia-smi"):
        bench.nvidia_smi_lines()
