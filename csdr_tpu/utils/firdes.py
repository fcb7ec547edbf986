"""FIR filter design (numpy, float64) — a re-derivation of the designs
the reference obtains from liquid-dsp.

The reference wraps liquid-dsp design routines behind FFI (see
/root/reference/src/ComposableSDR/Liquid.chs:471-501 firdecim kaiser,
:503-546 firhilbf, :730-866 firpfbch kaiser prototype, :868-916 firfilt kaiser,
:918-957 rnyquist designs). We re-derive each design from the published DSP
formulas (Kaiser window method, root-raised-cosine, half-band trick) rather than
translating liquid's code; tests validate responses against scipy oracles and
the stop-band attenuation specs recorded in SURVEY.md §2b.

All cutoff frequencies `fc` are normalized to the *sample rate* (liquid's
convention): fc = 0.25 means a quarter of fs (half of Nyquist).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "kaiser_beta",
    "kaiser_filter_len",
    "kaiser_lowpass",
    "firdecim_kaiser",
    "pfb_kaiser_prototype",
    "halfband_kaiser",
    "hilbert_halfband",
    "rrc",
    "root_nyquist_kaiser",
    "nyquist_kaiser",
    "gmsk_tx",
    "gmsk_rx",
    "fractional_delay",
    "group_delay",
]


def kaiser_beta(as_db: float) -> float:
    """Kaiser window shape parameter for a given stop-band attenuation in dB.

    Standard Kaiser empirical formula (Oppenheim & Schafer); same formula
    liquid-dsp uses for its kaiser designs.
    """
    as_db = abs(as_db)
    if as_db > 50.0:
        return 0.1102 * (as_db - 8.7)
    if as_db > 21.0:
        return 0.5842 * (as_db - 21.0) ** 0.4 + 0.07886 * (as_db - 21.0)
    return 0.0


def kaiser_filter_len(df: float, as_db: float) -> int:
    """Estimate required filter length for transition bandwidth ``df``
    (normalized to fs) and stop-band attenuation ``as_db`` (dB).

    Kaiser's length estimate N ≈ (As − 7.95) / (14.26·Δf).
    """
    if df <= 0:
        raise ValueError("transition bandwidth must be positive")
    n = int(np.ceil((abs(as_db) - 7.95) / (14.26 * df)))
    return max(n, 3)


def kaiser_lowpass(n: int, fc: float, as_db: float = 60.0, mu: float = 0.0) -> np.ndarray:
    """Kaiser-windowed-sinc lowpass prototype of length ``n``.

    ``fc``: cutoff normalized to sample rate (0 < fc <= 0.5).
    ``mu``: fractional sample delay offset (reference exposes this through
    firfilt_crcf_create_kaiser's `mu` argument, always 0 in the CLI).

    Returned with ~unity passband gain, i.e. h = 2·fc·sinc(2·fc·t)·w.  (liquid
    returns the un-normalized sinc and the reference then applies
    `set_scale(2·fc)` — Liquid.chs:892; we fold that scale into the design.)
    """
    if not 0.0 < fc <= 0.5:
        raise ValueError(f"fc must be in (0, 0.5], got {fc}")
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0 + mu
    h = 2.0 * fc * np.sinc(2.0 * fc * t)
    w = np.kaiser(n, kaiser_beta(as_db))
    return h * w


def firdecim_kaiser(m: int, semilen: int, as_db: float = 60.0) -> np.ndarray:
    """Decimate-by-``m`` anti-alias FIR, kaiser design.

    Mirrors the spec of the reference's `firdecim_rrrf_create_kaiser(m, 10, 60)`
    (Liquid.chs:487): length 2·m·semilen + 1, cutoff 0.5/m, normalized so the
    decimator has unity passband gain.
    """
    n = 2 * m * semilen + 1
    h = kaiser_lowpass(n, 0.5 / m, as_db)
    return h / h.sum()


def pfb_kaiser_prototype(nch: int, taps_per_branch_semilen: int, as_db: float = 80.0) -> np.ndarray:
    """Polyphase filterbank channelizer prototype.

    Spec from the reference's `firpfbch_crcf_create_kaiser(0, nch, 7, 80)`
    (Liquid.chs:813): kaiser prototype, semi-length m per branch, 80 dB
    stop-band, cutoff 0.5/nch.  Length 2·nch·m (trailing sample of the odd
    2·nch·m+1 design dropped so branches have equal length 2·m).
    Normalized to unity DC gain per channel (sum = nch ... we normalize so that
    a DC input yields unit output in channel containing DC).
    """
    m = taps_per_branch_semilen
    n = 2 * nch * m + 1
    h = kaiser_lowpass(n, 0.5 / nch, as_db)
    h = h[:-1]  # even length => exactly 2m taps per branch
    return h * (nch / h.sum())


def halfband_kaiser(semilen: int, as_db: float = 60.0) -> np.ndarray:
    """Half-band lowpass (fc = 0.25) of length 4·semilen + 1, kaiser window.

    Every second tap (except the center) is exactly zero by construction; used
    for the 2:1 stages of the multi-stage resampler and the Hilbert transform.
    """
    n = 4 * semilen + 1
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    h = 0.5 * np.sinc(0.5 * t)
    h *= np.kaiser(n, kaiser_beta(as_db))
    # force exact zeros at even offsets from center (numerical hygiene)
    center = (n - 1) // 2
    idx = np.arange(n)
    h[(idx != center) & ((idx - center) % 2 == 0)] = 0.0
    return h / h.sum() * 0.5  # unity passband for 2:1 decimation use


def hilbert_halfband(semilen: int = 5, as_db: float = 60.0) -> np.ndarray:
    """Half-band filter underlying the firhilbf-style real<->complex converter
    (reference: `firhilbf_create 5 60.0`, Liquid.chs:522).

    Returns the real half-band lowpass; the Hilbert structure (quadrature
    split + 2:1 rate change) is built in ops/hilbert.py from this prototype.
    """
    h = halfband_kaiser(semilen, as_db)
    return h * 2.0  # unity gain at DC for interpolation-style use


def rrc(k: int, m: int, beta: float) -> np.ndarray:
    """Root-raised-cosine matched filter: k samples/symbol, semi-length m
    symbols, roll-off beta.  Length 2·k·m + 1.  (Reference uses RRC via
    symtrack, Liquid.chs:158-166.)"""
    if beta <= 0 or beta > 1:
        beta = max(min(beta, 1.0), 1e-3)
    n = 2 * k * m + 1
    t = (np.arange(n, dtype=np.float64) - (n - 1) / 2.0) / k
    h = np.empty(n, dtype=np.float64)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - beta + 4.0 * beta / np.pi
        elif abs(abs(4.0 * beta * ti) - 1.0) < 1e-9:
            h[i] = (beta / np.sqrt(2.0)) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta))
            )
        else:
            num = np.sin(np.pi * ti * (1.0 - beta)) + 4.0 * beta * ti * np.cos(
                np.pi * ti * (1.0 + beta)
            )
            den = np.pi * ti * (1.0 - (4.0 * beta * ti) ** 2)
            h[i] = num / den
    return h / np.sqrt(k)


def nyquist_kaiser(k: int, m: int, beta: float) -> np.ndarray:
    """Kaiser-windowed Nyquist (ISI-free) filter: k samp/sym, semi-len m."""
    n = 2 * k * m + 1
    t = (np.arange(n, dtype=np.float64) - (n - 1) / 2.0) / k
    h = np.sinc(t)
    # the roll-off enters through the stop-band target above (wider beta →
    # relaxed as_db → shorter effective transition); the window shape itself
    # depends only on as_db
    as_db = 60.0 if beta <= 0 else max(40.0, 60.0 * (1.0 - 0.3 * beta))
    w = np.kaiser(n, kaiser_beta(as_db))
    return h * w


def root_nyquist_kaiser(k: int, m: int, beta: float) -> np.ndarray:
    """Approximate root-Nyquist Kaiser filter ('ARKAISER'-equivalent,
    reference symsync ftype 7, Liquid.chs:225).

    Construction: frequency-domain square root of a Kaiser-windowed Nyquist
    prototype — a published general recipe for root-Nyquist design that avoids
    copying liquid's polynomial fit.  The cascade h*h (matched pair) is
    ISI-free to within the window's stop-band leakage.
    """
    n = 2 * k * m + 1
    g = nyquist_kaiser(k, m, beta)
    # zero-pad generously, sqrt in frequency domain (response is real and ~>=0)
    nfft = 1 << int(np.ceil(np.log2(16 * n)))
    G = np.fft.fft(np.fft.ifftshift(np.pad(g, ((nfft - n) // 2, nfft - n - (nfft - n) // 2))))
    Gr = np.maximum(G.real, 0.0)
    H = np.sqrt(Gr)
    h_full = np.fft.fftshift(np.fft.ifft(H).real)
    c = nfft // 2
    h = h_full[c - (n - 1) // 2 : c + (n - 1) // 2 + 1]
    # normalize so the matched cascade h*h has unity symbol-rate gain
    return h / np.sqrt(np.sum(h**2) * k)


def gmsk_tx(k: int, m: int, bt: float = 0.3) -> np.ndarray:
    """GMSK transmit pulse: Gaussian (bandwidth-time bt) convolved with a
    one-symbol rectangle; k samp/sym, semi-length m symbols."""
    n = 2 * k * m + 1
    t = (np.arange(n, dtype=np.float64) - (n - 1) / 2.0) / k
    # Gaussian frequency pulse integrated over symbol: standard GMSK phase pulse
    alpha = np.sqrt(2.0 / np.log(2.0)) * np.pi * bt

    def q(x):
        return 0.5 * (1.0 + erf_vec(alpha * x / np.sqrt(2.0)))

    h = q(t + 0.5) - q(t - 0.5)
    return h / h.sum()


def erf_vec(x: np.ndarray) -> np.ndarray:
    from math import erf

    return np.vectorize(erf)(np.asarray(x, dtype=np.float64))


def gmsk_rx(k: int, m: int, bt: float = 0.3) -> np.ndarray:
    """Approximate GMSK receive matched filter (reference firfilt rnyquist
    ftype 12 'GMSKRX', Liquid.chs:937).

    Designed so that gmsk_tx * gmsk_rx ≈ Nyquist: frequency-domain
    deconvolution of an RRC-like target by the tx pulse, regularized.
    """
    htx = gmsk_tx(k, m, bt)
    n = len(htx)
    target = nyquist_kaiser(k, m, max(bt, 0.2))
    nfft = 1 << int(np.ceil(np.log2(16 * n)))

    def pad_center(h):
        return np.pad(h, ((nfft - len(h)) // 2, nfft - len(h) - (nfft - len(h)) // 2))

    Ht = np.fft.fft(np.fft.ifftshift(pad_center(htx)))
    Hg = np.fft.fft(np.fft.ifftshift(pad_center(target)))
    eps = 1e-2 * np.max(np.abs(Ht))
    Hr = Hg * np.conj(Ht) / (np.abs(Ht) ** 2 + eps**2)
    hr = np.fft.fftshift(np.fft.ifft(Hr).real)
    c = nfft // 2
    h = hr[c - (n - 1) // 2 : c + (n - 1) // 2 + 1]
    # unity cascade gain at the symbol sampling instant
    return h / np.sum(h * htx)


def fractional_delay(h: np.ndarray, mu: float, extend: bool = False) -> np.ndarray:
    """Apply a fractional-sample timing offset ``mu`` ∈ (−1, 1) to real FIR
    taps via an exact frequency-domain linear phase (liquid's filter designs
    accept the same ``mu`` parameter; e.g. firfilt rnyquist,
    /root/reference/src/ComposableSDR/Liquid.chs:935-941).  The taps are
    zero-padded 8× so the shifted tails don't wrap.

    With ``extend=False`` the result keeps length n, truncating the one
    sample of spill past the window — fine for smoothly-decaying designs.
    ``extend=True`` returns n+1 taps capturing the spill exactly (needed for
    hard-truncated designs like gmsk_rx whose edge taps are large); a
    negative ``mu`` then also adds one integer sample of delay (irrelevant
    to matched filtering, which only cares about the fractional part)."""
    if mu == 0.0:
        return h
    if not -1.0 < mu < 1.0:
        raise ValueError(f"fractional delay mu={mu} not in (-1, 1)")
    n = len(h)
    nfft = 1 << int(np.ceil(np.log2(8 * n)))
    H = np.fft.rfft(h, nfft)
    f = np.fft.rfftfreq(nfft)
    y = np.fft.irfft(H * np.exp(-2j * np.pi * f * mu), nfft)
    if not extend:
        return y[:n]
    if mu > 0:
        return y[: n + 1]  # spill lands at index n
    return np.concatenate([y[-1:], y[:n]])  # spill wraps to index −1


def group_delay(h: np.ndarray, f: float = 0.0) -> float:
    """Group delay of FIR ``h`` at normalized frequency ``f`` (cycles/sample).
    Used by the stereo decoder to compensate the pilot filter's delay
    (reference: firfilt_crcf_groupdelay, Liquid.chs:1049)."""
    n = len(h)
    k = np.arange(n, dtype=np.float64)
    w = 2.0 * np.pi * f
    e = np.exp(-1j * w * k)
    H = np.sum(h * e)
    dH = np.sum(-1j * k * h * e)
    if abs(H) < 1e-12:
        return (n - 1) / 2.0
    return float(np.real(1j * dH / H))


@functools.lru_cache(maxsize=None)
def cached_kaiser_lowpass(n: int, fc: float, as_db: float = 60.0, mu: float = 0.0):
    return kaiser_lowpass(n, fc, as_db, mu)
