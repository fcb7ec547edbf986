"""Arbitrary-rate resampling: half-band cascade + rational polyphase stage.

Reference behavior: liquid msresamp_crcf (arbitrary multi-stage resampler,
/root/reference/src/ComposableSDR/Liquid.chs:56-117; CLI uses rate = bw/fs with
60 dB stop-band, apps/SoapySDR.hs:190-194).  liquid composes half-band
decimators with an arbitrary (fractional-phase) final stage whose output count
is data-dependent — poison for XLA's static shapes.

Design: the requested rate is approximated by a rational P/Q (continued
fractions, |error| < 1e-6 relative for any denominator ≤ 1024 — inaudible even
over an hour-long stream), making the output count per block *exact and
static*: a block of n = k·Q inputs yields k·P outputs.  The rational stage is
a polyphase interpolator evaluated with P·L statically-unrolled strided
fused multiply-adds (the phase schedule repeats every P outputs, so there is
no gather and no dynamic shape anywhere).
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import jax.numpy as jnp

from ..utils.firdes import kaiser_beta, kaiser_filter_len

__all__ = ["rational_approx", "rational_taps", "rational_resample_init",
           "rational_resample_stream"]


def rational_approx(rate: float, max_den: int = 1024) -> Fraction:
    f = Fraction(rate).limit_denominator(max_den)
    if f <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    return f


@functools.lru_cache(maxsize=None)
def rational_taps(P: int, Q: int, as_db: float = 60.0) -> np.ndarray:
    """(P, L) polyphase tap matrix for up-P/down-Q resampling.

    Prototype: kaiser lowpass at the upsampled rate fs·P with cutoff
    0.5·min(1/P, 1/Q) and gain P (interpolation energy compensation).
    """
    cutoff = 0.5 / max(P, Q)  # in upsampled-rate units
    # transition band: 20% of cutoff
    df = 0.2 * cutoff
    n = kaiser_filter_len(df, as_db)
    L = -(-n // P)  # taps per phase
    n = L * P
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * t)
    h *= np.kaiser(n, kaiser_beta(as_db))
    h *= P / h.sum()
    # polyphase decomposition: h_p[l] = h[l·P + p]
    return h.reshape(L, P).T.astype(np.float32).copy()  # (P, L)


def rational_resample_init(P: int, Q: int, as_db: float = 60.0, dtype=jnp.complex64):
    L = rational_taps(P, Q, as_db).shape[1]
    return jnp.zeros((L - 1,), dtype=dtype)


def rational_resample_stream(state, x: jnp.ndarray, P: int, Q: int, as_db: float = 60.0):
    """Resample one block: len(x) multiple of Q → output len(x)·P/Q.

    y[m] = Σ_l h_{phase[m]}[l] · x[base[m] − l],
    base[m] = ⌊m·Q/P⌋, phase[m] = (m·Q) mod P  — both periodic in m with
    period P, so for m = r·P + s:  y[r·P+s] = Σ_l h_{ph(s)}[l]·x[r·Q + b(s) − l].
    Each (s, l) term is one strided slice (stride Q) FMA: static shapes, no
    gather.
    """
    taps = rational_taps(P, Q, as_db)  # (P, L)
    L = taps.shape[1]
    n = x.shape[0]
    assert n % Q == 0, (n, Q)
    nout = (n // Q) * P
    R = nout // P  # outputs per phase-lane
    xfull = jnp.concatenate([state, x])  # length n + L − 1; x[j] at index j + L − 1

    if P * L > 2048:
        # awkward rationals (large P): gather formulation — windows and tap
        # rows selected with device gathers instead of P·L unrolled slices
        mo = np.arange(nout, dtype=np.int64)
        base_o = ((mo * Q) // P).astype(np.int32)
        phase_o = ((mo * Q) % P).astype(np.int32)
        offs = (L - 1) - np.arange(L, dtype=np.int32)
        idx = jnp.asarray(base_o[:, None] + offs[None, :])
        win = xfull[idx]                                    # (nout, L)
        tap_rows = jnp.asarray(taps)[jnp.asarray(phase_o)]  # (nout, L)
        y = jnp.sum(win * tap_rows.astype(win.dtype), axis=-1)
        new_state = xfull[n:] if L > 1 else state
        return new_state, y

    m = np.arange(P)
    base = (m * Q) // P
    phase = (m * Q) % P

    lanes = []
    for s in range(P):
        hp = taps[phase[s]]
        acc = None
        for l in range(L):
            t = hp[l]
            if t == 0.0:
                continue
            start = base[s] - l + (L - 1)
            seg = xfull[start : start + (R - 1) * Q + 1 : Q]
            term = seg * t
            acc = term if acc is None else acc + term
        if acc is None:
            acc = jnp.zeros((R,), dtype=xfull.dtype)
        lanes.append(acc)
    y = jnp.stack(lanes, axis=1).reshape(nout)
    new_state = xfull[n:] if L > 1 else state
    return new_state, y
