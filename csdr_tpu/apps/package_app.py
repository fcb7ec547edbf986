"""csdr-package — self-contained application bundler.

The reference ships `cabal2appimage` (/root/reference/apps/Cabal2AppImage.hs):
walk the ldd closure of the built binaries, prune a system-library exclude
list, bundle SoapySDR driver modules, emit an AppImage.  The Python/JAX
equivalent: build a zipapp (.pyz) of the framework + CLI entry points, bundle
the native IO library plus its pruned ldd closure, and emit a directory with
a launcher — one artifact deployable to any GPU host with a matching
python/jax install.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import zipapp

__all__ = ["build_bundle", "ldd_closure", "main"]

# system libraries never bundled (the reference maintains the same idea in
# excludelist.txt)
_EXCLUDE = {
    "linux-vdso", "ld-linux", "libc.so", "libm.so", "libpthread", "libdl.so",
    "librt.so", "libgcc_s", "libstdc++",
}

_MAIN = """\
import sys

def main():
    prog = sys.argv[1] if len(sys.argv) > 1 else "soapy-sdr"
    args = sys.argv[2:]
    if prog in ("soapy-sdr", "soapy_sdr"):
        from csdr_tpu.apps.soapy_sdr_cli import main as m
    elif prog == "helidecode":
        from csdr_tpu.apps.helidecode import main as m
    else:
        print("usage: csdr.pyz [soapy-sdr|helidecode] <args...>")
        return 1
    return m(args)

if __name__ == "__main__":
    sys.exit(main())
"""


def ldd_closure(binary: str) -> list[str]:
    """Transitive shared-library dependencies, minus the exclude list
    (reference Cabal2AppImage.hs:52-69)."""
    try:
        out = subprocess.run(["ldd", binary], capture_output=True, text=True,
                             timeout=30).stdout
    except Exception:
        return []
    libs = []
    for line in out.splitlines():
        m = re.search(r"=>\s*(\S+)\s*\(", line)
        if not m:
            continue
        path = m.group(1)
        name = os.path.basename(path)
        if any(name.startswith(e) for e in _EXCLUDE):
            continue
        libs.append(path)
    return libs


# the framework's actual runtime dependency closure (the host venv may carry
# unrelated heavyweights — torch, transformers — that a deployed receiver
# never imports).  The CUDA entries are JAX's GPU plugin and the pip CUDA
# libraries it loads; without them a bundled receiver falls back to the CPU.
# A trailing "*" matches every package whose name starts with the prefix.
_CUDA_DEPS = ("jax_cuda*", "jax_plugins", "nvidia*")
_RUNTIME_DEPS = ("jax", "jaxlib", "numpy", "scipy", "ml_dtypes",
                 "opt_einsum") + _CUDA_DEPS


def _wanted(entry: str, deps: tuple) -> bool:
    """Does site-packages ``entry`` (package dir, module or dist-info)
    belong to one of ``deps``?"""
    stem = entry.split("-")[0].split(".")[0].lower()
    return any(stem == d or entry.lower() == d
               or (d.endswith("*") and stem.startswith(d[:-1]))
               for d in deps)


def bundle_runtime(out_dir: str, deps: tuple = _RUNTIME_DEPS) -> None:
    """Make the bundle fully self-contained (reference AppImage parity,
    Cabal2AppImage.hs:119-156): copy the running python interpreter + its
    ldd closure and the environment's site-packages into the bundle, so the
    target host needs nothing beyond a compatible libc (the same contract an
    AppImage makes).  Size is dominated by jaxlib (~hundreds of MB) — that
    IS the application runtime, exactly as GHC's RTS is baked into the
    reference's binary."""
    import sysconfig

    rt = os.path.join(out_dir, "runtime")
    bindir = os.path.join(rt, "bin")
    libdir = os.path.join(rt, "lib")
    os.makedirs(bindir, exist_ok=True)
    os.makedirs(libdir, exist_ok=True)
    py = os.path.realpath(sys.executable)
    shutil.copy2(py, os.path.join(bindir, "python3"))
    for dep in ldd_closure(py):
        try:
            shutil.copy2(dep, libdir)
        except OSError:
            pass
    # the interpreter's stdlib
    stdlib = sysconfig.get_paths()["stdlib"]
    dst_std = os.path.join(rt, "stdlib")
    if not os.path.exists(dst_std):
        shutil.copytree(stdlib, dst_std, symlinks=True,
                        ignore=shutil.ignore_patterns("__pycache__", "test",
                                                      "idlelib", "tkinter"),
                        dirs_exist_ok=True)
    # site-packages: only the requested dependency closure (see _RUNTIME_DEPS)
    dst_sp = os.path.join(rt, "site-packages")
    os.makedirs(dst_sp, exist_ok=True)
    for sp in set(p for p in sys.path if p.endswith("site-packages")):
        if not os.path.isdir(sp):
            continue
        for entry in os.listdir(sp):
            if not _wanted(entry, deps):
                continue
            srcp = os.path.join(sp, entry)
            dstp = os.path.join(dst_sp, entry)
            if os.path.isdir(srcp):
                shutil.copytree(srcp, dstp, symlinks=True,
                                ignore=shutil.ignore_patterns("__pycache__",
                                                              "*.pyc"),
                                dirs_exist_ok=True)
            else:
                shutil.copy2(srcp, dstp)
    # native .so dependencies of the bundled extension modules ride along
    # via the interpreter closure + manylinux self-contained wheels


def build_bundle(out_dir: str, repo_root: str | None = None,
                 self_contained: bool = False,
                 runtime_deps: tuple = _RUNTIME_DEPS) -> str:
    """``runtime_deps`` narrows the bundled site-packages closure — the
    CPU-only smoke test drops the CUDA packages (gigabytes of libraries) to
    keep the env -i launch test fast; production bundles ship the full
    default closure."""
    root = repo_root or os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.makedirs(out_dir, exist_ok=True)
    staging = os.path.join(out_dir, "_staging")
    if os.path.exists(staging):
        shutil.rmtree(staging)
    shutil.copytree(os.path.join(root, "csdr_tpu"), os.path.join(staging, "csdr_tpu"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(staging, "__main__.py"), "w") as f:
        f.write(_MAIN)
    pyz = os.path.join(out_dir, "csdr.pyz")
    zipapp.create_archive(staging, pyz, interpreter="/usr/bin/env python3")
    shutil.rmtree(staging)

    # native library + pruned dependency closure
    libdir = os.path.join(out_dir, "lib")
    os.makedirs(libdir, exist_ok=True)
    so = os.path.join(root, "native", "libcsdr_io.so")
    if os.path.exists(so):
        shutil.copy2(so, libdir)
        for dep in ldd_closure(so):
            try:
                shutil.copy2(dep, libdir)
            except OSError:
                pass

    launcher = os.path.join(out_dir, "csdr")
    if self_contained:
        bundle_runtime(out_dir, deps=runtime_deps)
        with open(launcher, "w") as f:
            f.write(
                '#!/bin/sh\nHERE="$(dirname "$(readlink -f "$0")")"\n'
                'export LD_LIBRARY_PATH="$HERE/lib:$HERE/runtime/lib:'
                '$LD_LIBRARY_PATH"\n'
                'export CSDR_NATIVE_LIB="$HERE/lib/libcsdr_io.so"\n'
                'export PYTHONHOME="$HERE/runtime"\n'
                'export PYTHONPATH="$HERE/runtime/stdlib:'
                '$HERE/runtime/stdlib/lib-dynload:$HERE/runtime/site-packages"\n'
                'exec "$HERE/runtime/bin/python3" "$HERE/csdr.pyz" "$@"\n')
    else:
        with open(launcher, "w") as f:
            f.write('#!/bin/sh\nHERE="$(dirname "$(readlink -f "$0")")"\n'
                    'export LD_LIBRARY_PATH="$HERE/lib:$LD_LIBRARY_PATH"\n'
                    'export CSDR_NATIVE_LIB="$HERE/lib/libcsdr_io.so"\n'
                    'exec python3 "$HERE/csdr.pyz" "$@"\n')
    os.chmod(launcher, 0o755)
    return out_dir


def main(argv=None) -> int:
    args = list(argv) if argv is not None else sys.argv[1:]
    self_contained = "--self-contained" in args
    if self_contained:
        args.remove("--self-contained")
    out = args[0] if args else "dist"
    path = build_bundle(out, self_contained=self_contained)
    kind = "self-contained " if self_contained else ""
    print(f"{kind}bundle written to {path}/ (launcher: {path}/csdr)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
