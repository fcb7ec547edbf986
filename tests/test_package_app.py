"""csdr-package bundler (cabal2appimage analogue)."""

import os
import subprocess
import sys
import zipfile

from csdr_tpu.apps.package_app import build_bundle


def test_build_bundle(tmp_path):
    out = build_bundle(str(tmp_path / "dist"))
    pyz = os.path.join(out, "csdr.pyz")
    assert os.path.exists(pyz)
    assert os.path.exists(os.path.join(out, "csdr"))
    with zipfile.ZipFile(pyz) as z:
        names = z.namelist()
        assert "__main__.py" in names
        assert any(n.startswith("csdr_tpu/apps/soapy_sdr_cli") for n in names)
    # launcher usage line works without jax initialization
    r = subprocess.run([sys.executable, pyz, "unknown-prog"],
                       capture_output=True, text=True, timeout=60)
    assert "usage" in r.stdout


def test_bundle_native_lib_is_loadable(tmp_path, monkeypatch):
    """The launcher points CSDR_NATIVE_LIB at the bundled .so; load_lib must
    honor it (inside the zipapp, the repo-relative path never exists —
    regression: deployed bundles silently lost native IO)."""
    out = build_bundle(str(tmp_path / "dist"))
    launcher = open(os.path.join(out, "csdr")).read()
    assert 'CSDR_NATIVE_LIB="$HERE/lib/libcsdr_io.so"' in launcher
    so = os.path.join(out, "lib", "libcsdr_io.so")
    if not os.path.exists(so):
        import pytest
        pytest.skip("native lib was not built on this host")
    import csdr_tpu.io.native as native

    monkeypatch.setenv("CSDR_NATIVE_LIB", so)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    lib = native.load_lib()
    assert lib is not None
    monkeypatch.setattr(native, "_lib", None)  # don't leak the bundle's lib


def test_native_lib_env_missing_path_raises(monkeypatch):
    import pytest

    import csdr_tpu.io.native as native

    monkeypatch.setenv("CSDR_NATIVE_LIB", "/nonexistent/libcsdr_io.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    with pytest.raises(RuntimeError, match="nonexistent"):
        native.load_lib()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)


def test_self_contained_bundle_runs_under_env_i(tmp_path):
    """`csdr-package --self-contained` parity with the reference AppImage
    (Cabal2AppImage.hs:119-156): the bundle ships interpreter + ldd closure +
    stdlib + pruned site-packages, and its launcher runs a real cf32->WAV
    demod flow under `env -i` (only PATH for the launcher's readlink/dirname
    and JAX_PLATFORMS=cpu to keep the smoke test on the CPU).  The CUDA
    plugin packages (gigabytes of libraries) are excluded from the smoke
    bundle via runtime_deps; everything else is the production
    self-contained path."""
    import numpy as np

    from csdr_tpu.apps.package_app import _CUDA_DEPS, _RUNTIME_DEPS

    deps = tuple(d for d in _RUNTIME_DEPS if d not in _CUDA_DEPS)
    out = build_bundle(str(tmp_path / "dist"), self_contained=True,
                       runtime_deps=deps)
    launcher = os.path.join(out, "csdr")
    assert os.path.exists(os.path.join(out, "runtime", "bin", "python3"))
    assert os.path.isdir(os.path.join(out, "runtime", "stdlib"))
    assert os.path.isdir(os.path.join(out, "runtime", "site-packages", "jax"))

    # tiny FM capture
    n = 16384
    t = np.arange(n)
    msg = 0.5 * np.sin(2 * np.pi * 0.002 * t)
    iq = np.exp(1j * np.cumsum(2 * np.pi * 0.1 * msg)).astype(np.complex64)
    cap = str(tmp_path / "cap.cf32")
    iq.tofile(cap)

    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "HOME": str(tmp_path)}
    r = subprocess.run(
        ["env", "-i"] + [f"{k}={v}" for k, v in env.items()] +
        [launcher, "soapy-sdr", "--filename", cap, "-s", "64000",
         "-n", str(n), "--demod", "DeNBFM 0.6 WAV", "-o",
         str(tmp_path / "audio")],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    wav = str(tmp_path / "audio.wav")
    assert os.path.exists(wav)
    # byte-accounting invariant: n output samples (rate 1) * 4 B + 44 header
    assert os.path.getsize(wav) == n * 4 + 44
