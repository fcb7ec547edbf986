"""Streaming IIR evaluation via parallel one-pole recurrences.

Replaces liquid-dsp's per-sample SOS loops (iirfilt_{crcf,rrrf}_execute_block,
/root/reference/src/ComposableSDR/Liquid.chs:563-651) with the blocked-matmul
recurrence solver in ops/linrec.py.  A Butterworth biquad is decomposed
(utils/iirdes.sos_to_onepole) into a 3-tap FIR numerator plus one or two
complex one-pole partial fractions; each pole's recurrence is solved in
parallel over the whole block.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..utils.iirdes import OnePoleCascade
from .fir import fir_stream
from .linrec import linrec

__all__ = ["onepole_cascade_init", "onepole_cascade_stream", "dc_blocker_stream",
           "dc_blocker_init", "dc_blocker_shard_stream"]


def onepole_cascade_init(casc: OnePoleCascade, complex_input: bool):
    """State pytree: per stage, FIR history (2 samples) + pole carries."""
    xdt = jnp.complex64 if complex_input else jnp.float32
    state = []
    for s in range(casc.poles.shape[0]):
        fir_hist = jnp.zeros((2,), dtype=xdt)
        carries = jnp.zeros((2,), dtype=jnp.complex64)
        state.append((fir_hist, carries))
    return tuple(state)


def _local_linrec(v, a, carry):
    u = linrec(v, a, carry)
    return u, u[-1]


def onepole_cascade_stream(casc: OnePoleCascade, state, x: jnp.ndarray,
                           linrec_fn=None, fir_fn=None):
    """Apply the cascade to one block.  Real input uses the conjugate-pair
    shortcut (y = 2·Re(r·u)); complex input evaluates both poles.

    ``linrec_fn(v, a, carry) -> (u, new_carry)`` and
    ``fir_fn(taps, hist, x) -> (new_hist, v)`` default to the single-device
    primitives; core/sharding injects distributed versions (halo-exchanged
    FIR history, closed-form cross-device recurrence carries) so the sharded
    IIR path runs the *same* cascade algebra."""
    if linrec_fn is None:
        linrec_fn = _local_linrec
    if fir_fn is None:
        fir_fn = fir_stream
    complex_input = jnp.iscomplexobj(x)
    new_state = []
    for s in range(casc.poles.shape[0]):
        fir_hist, carries = state[s]
        b = casc.fir[s]
        p0, p1 = casc.poles[s]
        r0, r1 = casc.residues[s]
        fir_hist, v = fir_fn(np.asarray(b), fir_hist, x)
        if p1 == 0.0:
            # single real (or absent) pole
            if p0 == 0.0:
                y = (v * np.float32(r0.real)) if not complex_input else v * np.complex64(r0)
                new_carries = carries
            else:
                u, u_end = linrec_fn(v, complex(p0) if abs(p0.imag) > 0 else float(p0.real),
                                     carries[0])
                y = u * (np.complex64(r0) if complex_input or abs(p0.imag) > 0 else np.float32(r0.real))
                if jnp.iscomplexobj(y) and not complex_input:
                    y = y.real
                new_carries = jnp.stack([jnp.asarray(u_end, dtype=jnp.complex64), carries[1]])
        else:
            if complex_input:
                u0, u0_end = linrec_fn(v, complex(p0), carries[0])
                u1, u1_end = linrec_fn(v, complex(p1), carries[1])
                y = np.complex64(r0) * u0 + np.complex64(r1) * u1
                new_carries = jnp.stack([
                    jnp.asarray(u0_end, dtype=jnp.complex64),
                    jnp.asarray(u1_end, dtype=jnp.complex64),
                ])
            elif abs(np.conj(p0) - p1) < 1e-9 and abs(p0.imag) > 0:
                # conjugate pair on real input: y = 2·Re(r0·u0)
                u0, u0_end = linrec_fn(v.astype(jnp.complex64), complex(p0), carries[0])
                y = 2.0 * (np.complex64(r0) * u0).real
                new_carries = jnp.stack([
                    jnp.asarray(u0_end, dtype=jnp.complex64),
                    jnp.conj(jnp.asarray(u0_end, dtype=jnp.complex64)),
                ])
            else:
                # two distinct REAL poles in one section (scipy pairs real
                # poles together, e.g. odd-order bandpass) — evaluate both
                u0, u0_end = linrec_fn(v, float(p0.real), carries[0].real)
                u1, u1_end = linrec_fn(v, float(p1.real), carries[1].real)
                y = np.float32(r0.real) * u0 + np.float32(r1.real) * u1
                new_carries = jnp.stack([
                    jnp.asarray(u0_end, dtype=jnp.complex64),
                    jnp.asarray(u1_end, dtype=jnp.complex64),
                ])
        new_state.append((fir_hist, new_carries))
        x = y.astype(jnp.complex64 if complex_input else jnp.float32)
    return tuple(new_state), x


def dc_blocker_init(complex_input: bool = True):
    # (1,)-shaped, not 0-d: the carry concatenates directly onto the
    # next block
    xdt = jnp.complex64 if complex_input else jnp.float32
    return (jnp.zeros((1,), dtype=xdt), jnp.zeros((1,), dtype=xdt))


def dc_blocker_shard_stream(state, x: jnp.ndarray, ctx, alpha: float = 0.0005):
    """Time-sharded DC blocker: the previous-input sample comes from the left
    neighbor's tail (1-sample halo) and the output recurrence carry is
    reconstructed in closed form across devices (ShardCtx.linrec) — the
    distributed layer over the same y[n] = r·y[n−1] + g·(x[n]−x[n−1])."""
    x_prev_last, y_last = state
    r = 1.0 - alpha
    g = np.float32((1.0 + r) / 2.0)
    prev_last = ctx.left_halo(x, x_prev_last, 1)
    prev = jnp.concatenate([prev_last, x[:-1]])
    forcing = g * (x - prev)
    y, _, new_carry = ctx.linrec(forcing, float(r), y_last[0])
    return (ctx.from_last_time(x[-1:]), new_carry[None]), y


def dc_blocker_stream(state, x: jnp.ndarray, alpha: float = 0.0005):
    """y[n] = r·y[n-1] + g·(x[n] − x[n-1]),  r = 1−alpha, g = (1+r)/2.

    Matches the reference's head-of-chain dc_blocker(0.0005)
    (Liquid.chs:577, applied at apps/SoapySDR.hs:213)."""
    x_prev_last, y_last = state
    r = 1.0 - alpha
    g = np.float32((1.0 + r) / 2.0)
    prev = jnp.concatenate([x_prev_last, x[:-1]])
    forcing = g * (x - prev)
    y = linrec(forcing, float(r), y_last[0])
    return (x[-1:], y[-1:]), y
