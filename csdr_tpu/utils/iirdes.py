"""IIR filter design — Butterworth prototypes as second-order sections, and the
decomposition into complex first-order sections that powers the parallel
recurrence engine (ops/linrec.py).

The reference obtains these from liquid-dsp's
`iirfilt_{crcf,rrrf}_create_prototype(BUTTER, LOWPASS, SOS, order, fc, ...)`
(/root/reference/src/ComposableSDR/Liquid.chs:553-651) and the special-cased
`iirfilt_crcf_create_dc_blocker(alpha)` (Liquid.chs:577).  We design with
scipy (float64) and restructure for parallel evaluation:

A real SOS cascade is evaluated on the device not as a per-sample loop but as a
cascade of *complex one-pole* recurrences (partial fractions of each biquad),
each solved in parallel with blocked lower-triangular matmuls — see
ops/linrec.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.signal as sig

__all__ = ["butter_sos", "prototype_sos", "sos_to_onepole", "OnePoleCascade",
           "dc_blocker_coeffs", "IIR_PROTOTYPES"]

# liquid-dsp prototype families (LIQUID_IIRDES_{BUTTER,CHEBY1,CHEBY2,ELLIP,
# BESSEL}) — the reference's exported surface accepts order/fc/f0/Ap/As
# (/root/reference/src/ComposableSDR/Liquid.chs:591-651; the CLI itself only
# ever builds the Butterworth lowpass, but the API promises the full family).
IIR_PROTOTYPES = ("butter", "cheby1", "cheby2", "ellip", "bessel")


def butter_sos(order: int, fc: float) -> np.ndarray:
    """Butterworth lowpass, order ``order``, cutoff ``fc`` normalized to the
    sample rate (liquid convention, fc in (0, 0.5)).  Returns scipy SOS array
    (n_sections, 6).
    """
    if not 0.0 < fc < 0.5:
        raise ValueError(f"fc must be in (0, 0.5), got {fc}")
    return sig.butter(order, 2.0 * fc, btype="low", output="sos")


def prototype_sos(ftype: str, order: int, fc: float, f0: float = 0.0,
                  ap: float = 1.0, as_db: float = 40.0) -> np.ndarray:
    """Design an IIR prototype as SOS — the full surface liquid backs
    `iirfilt_*_create_prototype` with (butter/cheby1/cheby2/ellip/bessel;
    /root/reference/src/ComposableSDR/Liquid.chs:611-634 hard-codes BUTTER but
    exports fc/f0/Ap/As).

    ``fc``: cutoff (lowpass) or half-bandwidth (bandpass), normalized to the
    sample rate.  ``f0``: 0 → lowpass; else band center → bandpass over
    [f0−fc, f0+fc] (liquid's LP→BP transform semantics).  ``ap``: passband
    ripple dB (cheby1/ellip).  ``as_db``: stopband attenuation dB
    (cheby2/ellip).  Designed in float64 with scipy (the test oracle is the
    same design evaluated by scipy.signal.sosfilt — SURVEY.md §4).
    """
    if ftype not in IIR_PROTOTYPES:
        raise ValueError(f"unknown IIR prototype {ftype!r}; expected one of "
                         f"{IIR_PROTOTYPES}")
    if not 0.0 < fc < 0.5:
        raise ValueError(f"fc must be in (0, 0.5), got {fc}")
    if f0:
        lo, hi = 2.0 * (f0 - fc), 2.0 * (f0 + fc)
        if not 0.0 < lo < hi < 1.0:
            raise ValueError(f"bandpass edges out of range: f0={f0}, fc={fc}")
        wn, btype = (lo, hi), "bandpass"
    else:
        wn, btype = 2.0 * fc, "low"
    if ftype == "butter":
        return sig.butter(order, wn, btype=btype, output="sos")
    if ftype == "cheby1":
        return sig.cheby1(order, ap, wn, btype=btype, output="sos")
    if ftype == "cheby2":
        return sig.cheby2(order, as_db, wn, btype=btype, output="sos")
    if ftype == "ellip":
        return sig.ellip(order, ap, as_db, wn, btype=btype, output="sos")
    return sig.bessel(order, wn, btype=btype, output="sos", norm="mag")


@dataclasses.dataclass(frozen=True)
class OnePoleCascade:
    """A filter expressed as cascade of stages; each stage is
    y = b_fir * x (3-tap FIR) followed by partial-fraction one-pole terms:

        y[n] = Re-combine of  u_i[n] = p_i · u_i[n−1] + x[n]

    poles:    (n_stages, 2) complex — pole pair per stage (p, p̄) or (p, 0)
    residues: (n_stages, 2) complex — partial-fraction coefficients
    fir:      (n_stages, 3) float   — numerator taps per stage
    real_io:  whether input/output of the whole cascade is real
    """

    poles: np.ndarray
    residues: np.ndarray
    fir: np.ndarray
    real_io: bool


def sos_to_onepole(sos: np.ndarray, real_io: bool = True) -> OnePoleCascade:
    """Decompose an SOS cascade into FIR numerators + one-pole partial
    fractions.

    For a section with denominator 1 + a1 z⁻¹ + a2 z⁻² and poles p, q:
        1/A(z) = r_p/(1 − p z⁻¹) + r_q/(1 − q z⁻¹),  r_p = p/(p−q), r_q = −q/(p−q)
    (distinct poles; Butterworth poles are distinct).  For a first-order
    section (a2 == 0): single pole p = −a1, residue 1.
    """
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    n = sos.shape[0]
    poles = np.zeros((n, 2), dtype=np.complex128)
    residues = np.zeros((n, 2), dtype=np.complex128)
    fir = np.zeros((n, 3), dtype=np.float64)
    for i, (b0, b1, b2, a0, a1, a2) in enumerate(sos):
        b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
        fir[i] = (b0, b1, b2)
        if abs(a2) < 1e-300 and abs(a1) < 1e-300:
            poles[i] = (0.0, 0.0)
            residues[i] = (1.0, 0.0)
        elif abs(a2) < 1e-300:
            poles[i] = (-a1, 0.0)
            residues[i] = (1.0, 0.0)
        else:
            disc = np.sqrt(complex(a1 * a1 - 4.0 * a2))
            p = (-a1 + disc) / 2.0
            q = (-a1 - disc) / 2.0
            if abs(p - q) < 1e-12:
                # repeated pole: nudge to keep partial fractions well-posed
                p *= 1.0 + 1e-7
            poles[i] = (p, q)
            residues[i] = (p / (p - q), -q / (p - q))
    return OnePoleCascade(poles=poles, residues=residues, fir=fir, real_io=real_io)


def dc_blocker_coeffs(alpha: float = 0.0005) -> tuple[np.ndarray, np.ndarray]:
    """DC-blocking one-pole notch: H(z) = (1 − z⁻¹) / (1 − (1−alpha) z⁻¹).

    Matches the behavior of the reference's dc_blocker with alpha = 0.0005
    (Liquid.chs:577).  Returns (b, a) with b = [g, -g], a = [1, -(1-alpha)];
    gain g chosen for unity response at Nyquist.
    """
    r = 1.0 - alpha
    g = (1.0 + r) / 2.0
    b = np.array([g, -g], dtype=np.float64)
    a = np.array([1.0, -r], dtype=np.float64)
    return b, a
