"""Plain NumPy float64 reference of the flagship chain.

dc_blocker → NCO pre-shift → polyphase filterbank → DFT → per-channel FM
demod (the reference CLI's `-c N --demod "DeNBFM kf ..."` flow,
/root/reference/apps/SoapySDR.hs:208-226 with liquid's firpfbch_crcf and
freqdem).  Written from the DSP definitions alone, independent of the code
under test: it calls no `csdr_tpu` op or filter design, only numpy and
scipy.signal.lfilter, so tests and `chip_smoke.py` can hold the device path
to it.  The whole input is processed as one block, so its output is what
any streaming split of the same input must reproduce.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

__all__ = ["cu8_to_iq", "pfb_prototype", "flagship_reference",
           "channel_snr_db"]


def cu8_to_iq(u8: np.ndarray) -> np.ndarray:
    """Interleaved unsigned 8-bit IQ (rtl_sdr 'cu8') → complex128,
    (v − 127.5)/127.5 per component."""
    f = (np.asarray(u8, dtype=np.float64) - 127.5) / 127.5
    return f[0::2] + 1j * f[1::2]


def pfb_prototype(nch: int, m: int = 7, as_db: float = 80.0) -> np.ndarray:
    """liquid's firpfbch_crcf_create_kaiser(0, nch, m, as_db) prototype:
    kaiser-windowed sinc of length 2·nch·m + 1 at cutoff 0.5/nch, trailing
    sample dropped so each of the nch branches holds 2·m taps, normalized to
    unit gain at DC."""
    n = 2 * nch * m + 1
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    a = abs(as_db)
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a > 21.0:
        beta = 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    h = np.sinc(t / nch) * np.kaiser(n, beta)
    h = h[:-1]
    return h / h.sum()


def flagship_reference(iq: np.ndarray, nch: int, kf: float = 0.6,
                       m: int = 7, as_db: float = 80.0,
                       dc_alpha: float = 0.0005) -> np.ndarray:
    """(n,) complex IQ → (nch, n // nch) float64 FM audio per channel.

    Channel k is centered at (k − (nch−1)/2)/nch cycles/sample.  Stream
    semantics: every filter starts from rest, and the FM demod's previous
    sample starts at 1 (zero phase)."""
    x = np.asarray(iq, dtype=np.complex128)
    n = (len(x) // nch) * nch
    x = x[:n]
    # DC blocker: y[n] = r·y[n−1] + g·(x[n] − x[n−1]), r = 1−α, g = (1+r)/2
    r = 1.0 - dc_alpha
    g = (1.0 + r) / 2.0
    x = lfilter([g, -g], [1.0, -r], x)
    # NCO pre-shift by ω = −π(nch−1)/nch rad/sample (mix down: × e^{−jωn})
    omega = -np.pi * (nch - 1) / nch
    x = x * np.exp(-1j * np.mod(omega * np.arange(n, dtype=np.float64),
                                2.0 * np.pi))
    # polyphase filterbank, critically sampled:
    #   d_k[i] = Σ_j h[j] · x[i·nch − j] · e^{+j2πkj/nch}
    # branch p = j mod nch, tap l = j // nch:
    #   u[i, p] = Σ_l h[l·nch + p] · x[(i − l)·nch − p]
    h = pfb_prototype(nch, m, as_db).reshape(-1, nch)   # (L, nch)
    F = n // nch
    xp = np.concatenate([np.zeros(nch - 1, np.complex128), x])
    v = xp[:F * nch].reshape(F, nch)[:, ::-1]           # v[i, p] = x[i·nch − p]
    u = np.zeros((F, nch), np.complex128)
    for l in range(h.shape[0]):
        u[l:] += h[l][None, :] * v[:F - l]
    d = nch * np.fft.ifft(u, axis=1)                    # Σ_p u[i,p]·e^{+j2πkp/nch}
    # FM demod per channel: arg(d[i]·conj(d[i−1])) / (2π·kf)
    prev = np.concatenate([np.ones((1, nch), np.complex128), d[:-1]], axis=0)
    audio = np.angle(d * np.conj(prev)) / (2.0 * np.pi * kf)
    return audio.T


def channel_snr_db(ref: np.ndarray, got: np.ndarray) -> np.ndarray:
    """Per-channel SNR in dB of ``got`` against ``ref`` (both (nch, n)):
    10·log10(Σ ref² / Σ (got − ref)²), no alignment or gain fit."""
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    p_sig = np.sum(ref ** 2, axis=-1)
    p_err = np.sum(err ** 2, axis=-1)
    return 10.0 * np.log10((p_sig + 1e-300) / (p_err + 1e-300))
