"""Synthetic signal generation (modulators) and quality metrics.

The reference has no modulators or tests (SURVEY.md §4); these are the golden
oracles our test suite uses: generate a known message → modulate (numpy,
float64) → run the device demod pipeline → require SNR above spec.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "tone",
    "fm_mod",
    "am_mod",
    "fsk_mod",
    "snr_db",
    "awgn",
    "fm_channel_capture",
    "to_cu8",
]

_TWO_PI = 2.0 * np.pi


def tone(n: int, freq: float, fs: float = 1.0, amp: float = 1.0, phase: float = 0.0,
         complex_out: bool = True) -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    ph = _TWO_PI * (freq / fs) * t + phase
    if complex_out:
        return (amp * np.exp(1j * ph)).astype(np.complex64)
    return (amp * np.cos(ph)).astype(np.float32)


def fm_mod(message: np.ndarray, kf: float) -> np.ndarray:
    """liquid-compatible FM: phase[n] = phase[n-1] + 2π·kf·m[n]."""
    phase = _TWO_PI * kf * np.cumsum(np.asarray(message, dtype=np.float64))
    return np.exp(1j * phase).astype(np.complex64)


def am_mod(message: np.ndarray, mod_index: float = 0.8, suppressed: bool = False) -> np.ndarray:
    m = np.asarray(message, dtype=np.float64)
    if suppressed:
        s = mod_index * m
    else:
        s = (1.0 + mod_index * m) / (1.0 + mod_index)
    return s.astype(np.complex64)


def fsk_mod(symbols: np.ndarray, m_bits: int, k: int, bandwidth: float) -> np.ndarray:
    """M-FSK with tone mapping matching ops/demod.fsk_tone_matrix (continuous
    phase across symbols)."""
    M = 1 << m_bits
    sym = np.asarray(symbols, dtype=np.int64)
    f = bandwidth * (2.0 * sym - (M - 1)) / (M - 1)  # per symbol
    inst_f = np.repeat(f, k)
    phase = _TWO_PI * np.cumsum(inst_f)
    phase = np.concatenate([[0.0], phase[:-1]])
    return np.exp(1j * phase).astype(np.complex64)


def awgn(x: np.ndarray, snr_db_val: float, rng: np.random.Generator | None = None) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    p_sig = np.mean(np.abs(x) ** 2)
    p_noise = p_sig / (10.0 ** (snr_db_val / 10.0))
    if np.iscomplexobj(x):
        n = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
        n *= np.sqrt(p_noise / 2.0)
    else:
        n = rng.normal(size=x.shape) * np.sqrt(p_noise)
    return (x + n).astype(x.dtype)


def snr_db(ref: np.ndarray, test: np.ndarray, skip: int = 0, align: bool = True,
           scale: bool = True) -> float:
    """SNR of ``test`` against oracle ``ref`` after optional delay alignment
    (cross-correlation over ±64 samples) and optimal scalar fit.  This is the
    metric used for 'matches the reference within liquid-dsp's SNR bound'."""
    ref = np.asarray(ref, dtype=np.float64 if not np.iscomplexobj(ref) else np.complex128)
    test = np.asarray(test, dtype=ref.dtype)
    n = min(len(ref), len(test))
    ref, test = ref[:n], test[:n]
    if skip:
        ref, test = ref[skip:-skip or None], test[skip:-skip or None]
    if align:
        best, best_lag = -np.inf, 0
        for lag in range(-64, 65):
            r = ref[max(0, lag):len(ref) + min(0, lag)]
            t = test[max(0, -lag):len(test) + min(0, -lag)]
            m = min(len(r), len(t))
            if m < 16:
                continue
            c = np.abs(np.vdot(r[:m], t[:m]))
            denom = np.linalg.norm(r[:m]) * np.linalg.norm(t[:m]) + 1e-30
            if c / denom > best:
                best, best_lag = c / denom, lag
        lag = best_lag
        ref = ref[max(0, lag):]
        test = test[max(0, -lag):]
        m = min(len(ref), len(test))
        ref, test = ref[:m], test[:m]
    if scale:
        g = np.vdot(ref, test) / (np.vdot(ref, ref) + 1e-30)
        err = test - g * ref
    else:
        err = test - ref
    p_sig = np.mean(np.abs(ref) ** 2) + 1e-30
    p_err = np.mean(np.abs(err) ** 2) + 1e-30
    return float(10.0 * np.log10(p_sig / p_err))


def fm_channel_capture(n: int, nch: int, n_signal: int = 8, seed: int = 0,
                       kf: float = 0.6, amp: float = 0.1,
                       noise: float = 0.01) -> tuple[np.ndarray, list[int]]:
    """Seeded wideband capture for an nch-channel PFB + FM demod flow.

    FM carriers sit at the centers of ``min(n_signal, nch)`` evenly spread
    channels (channel k at (k − (nch−1)/2)/nch cycles/sample), each
    modulated by its own tone at a channel-rate deviation of about 0.1
    (kf·amplitude), under complex white noise of rms ``noise``.  Returns
    (iq complex64 (n,), sorted signal channel indices)."""
    rng = np.random.default_rng(seed)
    k_sig = sorted({int(k) for k in np.linspace(0, nch - 1, min(n_signal, nch))
                    .round()})
    t = np.arange(n, dtype=np.float64)
    x = noise / np.sqrt(2.0) * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for k in k_sig:
        fc = (k - (nch - 1) / 2.0) / nch
        fm = rng.uniform(0.005, 0.03) / nch        # tone, channel-rate 0.005-0.03
        dev = rng.uniform(0.1, 0.2) / kf           # message amplitude
        ph0 = rng.uniform(0.0, 2.0 * np.pi)
        # phase = 2π·fc·t + 2π·kf/nch·Σ m, with m = dev·sin(2π·fm·t)
        integ = dev * (1.0 - np.cos(_TWO_PI * fm * t)) / (_TWO_PI * fm)
        ph = np.mod(_TWO_PI * fc * t + _TWO_PI * kf / nch * integ + ph0,
                    _TWO_PI)
        x += amp * np.exp(1j * ph)
    return x.astype(np.complex64), k_sig


def to_cu8(iq: np.ndarray) -> np.ndarray:
    """complex IQ in [−1, 1] → interleaved rtl_sdr uint8 ('cu8'),
    round(v·127.5 + 127.5) clipped to 0..255."""
    iq = np.asarray(iq)
    f = np.empty(2 * len(iq), np.float64)
    f[0::2], f[1::2] = iq.real, iq.imag
    return np.clip(np.round(f * 127.5 + 127.5), 0, 255).astype(np.uint8)
