"""The persistent compilation cache helper used by the entry points."""

import os
import subprocess
import sys

import jax

from csdr_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_is_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        d = compile_cache.enable_compile_cache()
        assert d == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
        # the same path every call: nothing temporary, no pid, no time
        assert compile_cache.enable_compile_cache() == d
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_honoured_and_cache_lands_there(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper changes nothing and a
    compilation is written to that directory."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from csdr_tpu.utils.compile_cache import enable_compile_cache\n"
        "d = enable_compile_cache()\n"
        "jax.jit(lambda x: jnp.sin(x) * 2.0 + 1.0)(jnp.ones(8)).block_until_ready()\n"
        "print(d)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0",
               PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == str(tmp_path)
    assert any(os.scandir(tmp_path))
    assert not os.path.exists(os.path.join(str(tmp_path), ".jax_cache"))
