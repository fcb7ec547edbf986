"""Long real FIRs — the cases a banded-Toeplitz matmul kernel once served —
through conv_valid's "auto" strategy (now the XLA FFT overlap-save on every
platform) vs the scipy float64 convolution."""

import numpy as np
import pytest
import scipy.signal as sig

import jax.numpy as jnp

from csdr_tpu.ops.fir import conv_valid


@pytest.mark.parametrize("K,n", [(63, 4000), (128, 4096), (401, 10000), (1000, 8192)])
def test_pallas_fir_real(K, n):
    rng = np.random.default_rng(0)
    h = rng.normal(size=K)
    x = rng.normal(size=n).astype(np.float32)
    xfull = np.concatenate([np.zeros(K - 1, np.float32), x])
    y = np.asarray(conv_valid(jnp.asarray(xfull), h, strategy="auto"))
    want = sig.lfilter(h, [1.0], x.astype(np.float64))
    assert y.shape == want.shape
    assert np.max(np.abs(y - want)) < 2e-3 * np.max(np.abs(want))


def test_pallas_fir_complex():
    rng = np.random.default_rng(1)
    K, n = 200, 5000
    h = rng.normal(size=K)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    xfull = np.concatenate([np.zeros(K - 1, np.complex64), x])
    y = np.asarray(conv_valid(jnp.asarray(xfull), h, strategy="fft"))
    want = sig.lfilter(h, [1.0], x.astype(np.complex128))
    assert np.max(np.abs(y - want)) < 2e-3 * np.max(np.abs(want))
