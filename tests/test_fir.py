"""FIR engines vs scipy.signal oracles, including streaming-state equivalence."""

import numpy as np
import pytest
import scipy.signal as sig

import jax.numpy as jnp

from csdr_tpu.ops.fir import conv_valid, fir_stream, fir_decim_stream, fir_interp_stream


def causal_ref(x, h):
    """y[n] = sum_k h[k] x[n-k] with x[-i] = 0."""
    return sig.lfilter(h, [1.0], x)


@pytest.mark.parametrize("K,strategy", [(7, "slices"), (33, "slices"), (33, "fft"), (257, "fft")])
def test_conv_valid_real(K, strategy):
    rng = np.random.default_rng(0)
    h = rng.normal(size=K)
    x = rng.normal(size=5000).astype(np.float32)
    xfull = np.concatenate([np.zeros(K - 1, np.float32), x])
    y = np.asarray(conv_valid(jnp.asarray(xfull), h, strategy))
    yr = causal_ref(x.astype(np.float64), h)
    assert np.max(np.abs(y - yr)) < 1e-3 * np.max(np.abs(yr))


@pytest.mark.parametrize("strategy", ["slices", "fft"])
def test_conv_valid_complex(strategy):
    rng = np.random.default_rng(1)
    h = rng.normal(size=41) + 1j * rng.normal(size=41)
    x = (rng.normal(size=3000) + 1j * rng.normal(size=3000)).astype(np.complex64)
    xfull = np.concatenate([np.zeros(40, np.complex64), x])
    y = np.asarray(conv_valid(jnp.asarray(xfull), h, strategy))
    yr = causal_ref(x.astype(np.complex128), h)
    assert np.max(np.abs(y - yr)) < 2e-3 * np.max(np.abs(yr))


def test_fir_stream_blocks_equal_oneshot():
    rng = np.random.default_rng(2)
    h = rng.normal(size=61)
    x = rng.normal(size=8192).astype(np.float32)
    hist = jnp.zeros(60, jnp.float32)
    outs = []
    for i in range(0, 8192, 2048):
        hist, y = fir_stream(h, hist, jnp.asarray(x[i:i + 2048]))
        outs.append(np.asarray(y))
    got = np.concatenate(outs)
    want = causal_ref(x.astype(np.float64), h)
    assert np.max(np.abs(got - want)) < 1e-3 * np.max(np.abs(want))


@pytest.mark.parametrize("M,K,strategy", [(4, 41, "poly"), (4, 41, "fft"), (8, 161, "poly"),
                                          (20, 401, "fft"), (5, 13, "poly")])
def test_fir_decim_stream(M, K, strategy):
    rng = np.random.default_rng(3)
    h = rng.normal(size=K)
    n = 480 * M * 4  # 4 chunks, each a multiple of M
    x = rng.normal(size=n).astype(np.float32)
    hist = jnp.zeros(K - 1, jnp.float32)
    outs = []
    for i in range(0, n, n // 4):
        hist, y = fir_decim_stream(h, M, hist, jnp.asarray(x[i:i + n // 4]), strategy)
        outs.append(np.asarray(y))
    got = np.concatenate(outs)
    # oracle: full causal conv then take every M-th sample starting at 0
    full = causal_ref(x.astype(np.float64), h)
    want = full[::M]
    assert len(got) == len(want)
    assert np.max(np.abs(got - want)) < 2e-3 * np.max(np.abs(want))


def test_fir_interp_stream():
    rng = np.random.default_rng(4)
    P, K = 2, 21
    h = rng.normal(size=K)
    x = rng.normal(size=1024).astype(np.float32)
    Lsub = -(-K // P)
    hist = jnp.zeros(Lsub - 1, jnp.float32)
    outs = []
    for i in range(0, 1024, 256):
        hist, y = fir_interp_stream(h, P, hist, jnp.asarray(x[i:i + 256]))
        outs.append(np.asarray(y))
    got = np.concatenate(outs)
    u = np.zeros(1024 * P)
    u[::P] = x
    want = causal_ref(u, h)
    assert len(got) == len(want)
    assert np.max(np.abs(got - want)) < 2e-3 * (np.max(np.abs(want)) + 1e-12)


def test_auto_strategy_routing(monkeypatch):
    """auto: short -> slices; long (real or complex) -> XLA fft overlap-save
    on every platform."""
    import jax
    from csdr_tpu.ops.fir import _auto_strategy

    short = np.ones(32)
    long_real = np.ones(401)
    long_cplx = np.ones(401) + 1j

    assert _auto_strategy(short) == "slices"
    for platform in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert _auto_strategy(long_real) == "fft"
        assert _auto_strategy(long_cplx) == "fft"
        assert _auto_strategy(np.ones(128)) == "fft"