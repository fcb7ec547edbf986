"""conv_valid's "fft" overlap-save (XLA's FFT: cuFFT on the GPU) vs the
scipy float64 convolution: real and complex taps (stereo pilot band-pass /
firFilterCKaiser, Liquid.chs:868-916), very long filters, and streaming
through fir_stream with the "auto" choice.
"""

import numpy as np
import pytest
import scipy.signal as sig

import jax.numpy as jnp

from csdr_tpu.ops.fir import conv_valid, fir_stream
from csdr_tpu.utils import firdes


def oracle(xfull, taps):
    return sig.convolve(np.asarray(xfull, dtype=np.complex128),
                        np.asarray(taps, dtype=np.complex128),
                        mode="valid")


@pytest.mark.parametrize("K,n", [(401, 50_000), (33, 4096), (2048, 40_000),
                                 (1, 1024)])
def test_real_taps_real_input(K, n):
    rng = np.random.default_rng(0)
    taps = rng.normal(size=K) / np.sqrt(K)
    xfull = rng.normal(size=n + K - 1).astype(np.float32)
    got = np.asarray(conv_valid(jnp.asarray(xfull), taps, strategy="fft"))
    want = oracle(xfull, taps).real
    scale = np.max(np.abs(want)) + 1e-12
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / scale < 2e-4


@pytest.mark.parametrize("K", [143, 401])
def test_complex_taps_complex_input(K):
    """The stereo pilot FIR case: complex band-pass taps on IQ."""
    rng = np.random.default_rng(1)
    taps = firdes.kaiser_lowpass(K, 0.1, 60.0) * np.exp(
        2j * np.pi * 0.19 * np.arange(K))
    n = 30_000
    xfull = (rng.normal(size=n + K - 1)
             + 1j * rng.normal(size=n + K - 1)).astype(np.complex64)
    got = np.asarray(conv_valid(jnp.asarray(xfull), taps, strategy="fft"))
    want = oracle(xfull, taps)
    scale = np.max(np.abs(want)) + 1e-12
    assert np.max(np.abs(got - want)) / scale < 2e-4


def test_streaming_through_fir_stream():
    """conv_valid strategy plumbing + streaming state equivalence."""
    rng = np.random.default_rng(2)
    K = 401
    taps = firdes.kaiser_lowpass(K, 0.05, 60.0)
    x = rng.normal(size=2 * 16384).astype(np.float32)
    hist = jnp.zeros((K - 1,), jnp.float32)
    outs = []
    for i in range(0, len(x), 16384):
        hist, y = fir_stream(taps, hist, jnp.asarray(x[i:i + 16384]),
                             strategy="auto")
        outs.append(np.asarray(y))
    got = np.concatenate(outs)
    want = sig.lfilter(taps, 1.0, x.astype(np.float64))
    scale = np.max(np.abs(want)) + 1e-12
    assert np.max(np.abs(got - want)) / scale < 2e-4


def test_matches_xla_fft_strategy():
    rng = np.random.default_rng(3)
    K = 257
    taps = rng.normal(size=K) / 16
    xfull = (rng.normal(size=20_000 + K - 1)
             + 1j * rng.normal(size=20_000 + K - 1)).astype(np.complex64)
    a = np.asarray(conv_valid(jnp.asarray(xfull), taps, strategy="fft"))
    b = np.asarray(conv_valid(jnp.asarray(xfull), taps,
                              strategy="auto"))
    scale = np.max(np.abs(a)) + 1e-12
    assert np.max(np.abs(a - b)) / scale < 3e-4
