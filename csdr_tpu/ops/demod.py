"""Demodulator math: FM (phase differentiator), AM (envelope), M-FSK.

Reference behavior: liquid freqdem (Liquid.chs:303-334), ampmodem with
mod-index 0.8, DSB, non-suppressed carrier (Liquid.chs:439-469), fskdem
(Liquid.chs:336-382).  All are embarrassingly parallel on the device:

  * FM:  y[n] = arg(x[n]·conj(x[n-1])) / (2π·kf)   — one carried sample.
  * AM:  envelope detector matching our ampmod test modulator.
  * FSK: per-symbol tone-energy argmax — a (nsym, k) @ (k, M) complex matmul
         as one matmul, replacing liquid's per-symbol FFT loop.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from .constants import jnp_const

__all__ = ["freqdem_stream", "amdem", "fsk_tone_matrix", "fskdem_block"]

_TWO_PI = 2.0 * np.pi


def freqdem_stream(last: jnp.ndarray, x: jnp.ndarray, kf: float):
    """FM demodulate; ``last`` is the previous block's final sample, shaped
    (1,) (concatenates directly onto the next block).  Returns (new_last, y)
    with len(y) == len(x)."""
    prev = jnp.concatenate([last, x[:-1]])
    d = x * jnp.conj(prev)
    y = jnp.angle(d) * np.float32(1.0 / (_TWO_PI * kf))
    return x[-1:], y.astype(jnp.float32)


def amdem(x: jnp.ndarray, mod_index: float = 0.8, suppressed: bool = False) -> jnp.ndarray:
    """AM envelope demodulation.

    Non-suppressed carrier (reference default, ampmodem_create(0.8, DSB,
    carrier-on)): s = (1 + index·m)/(1+index)  ⇒  m = (|s|·(1+index) − 1)/index.
    Suppressed: m = |s| / index.  Residual DC rides out through the upstream
    DC blocker exactly as in the reference flow.
    """
    env = jnp.abs(x)
    if suppressed:
        return (env / np.float32(mod_index)).astype(jnp.float32)
    return ((env * np.float32(1.0 + mod_index) - 1.0) / np.float32(mod_index)).astype(jnp.float32)


@functools.lru_cache(maxsize=None)
def fsk_tone_matrix(m_bits: int, k: int, bandwidth: float) -> np.ndarray:
    """(k, M) conjugate tone matrix for M = 2^m_bits FSK correlation demod.

    Tone i sits at normalized frequency f_i = bandwidth·(2i − (M−1))/(M−1),
    spanning [−bw, +bw] (matched by utils/testsig.fsk_mod)."""
    M = 1 << m_bits
    i = np.arange(M, dtype=np.float64)
    f = bandwidth * (2.0 * i - (M - 1)) / (M - 1)
    t = np.arange(k, dtype=np.float64)
    E = np.exp(-1j * _TWO_PI * f[None, :] * t[:, None])
    return E.astype(np.complex64)


def fskdem_block(x: jnp.ndarray, m_bits: int, k: int, bandwidth: float) -> jnp.ndarray:
    """Demodulate len(x)//k M-FSK symbols: tone correlation + argmax.

    The (nsym, k) @ (k, M) complex matmul is one matmul; compare the
    reference's one-C-call-per-symbol loop (Liquid.chs:352-358)."""
    n = x.shape[0]
    nsym = n // k
    xs = x[: nsym * k].reshape(nsym, k)
    E = jnp_const(fsk_tone_matrix(m_bits, int(k), float(bandwidth)))
    corr = xs @ E  # (nsym, M) complex matmul
    sym = jnp.argmax(jnp.abs(corr) ** 2, axis=-1)
    return sym.astype(jnp.uint32)
