"""Parallel first-order linear recurrences on the device.

The reference evaluates every IIR filter / AGC / DC-blocker as a per-sample C
loop inside liquid-dsp (e.g. iirfilt execute_block, agc_crcf per-sample loop —
/root/reference/src/ComposableSDR/Liquid.chs:563-705).  A per-sample loop is
the worst possible accelerator program, so this module solves the recurrence

    y[n] = a · y[n-1] + b[n],        y[-1] = y0

*in parallel* with a blocked algorithm that maps onto matrix multiplies:

  1. reshape the forcing sequence into (B, L) blocks,
  2. within-block solve with zero carry  w = b @ Tᵀ, where T is the static
     lower-triangular decay matrix T[i, j] = a^(i-j)  — one big matmul,
  3. propagate block carries g[k] = a^L · g[k-1] + w[k, L-1] with a log-depth
     associative scan over B elements,
  4. add the carried term  y[k, i] = w[k, i] + a^(i+1) · g[k-1].

Complex coefficients are supported (a biquad = conjugate pole pair = one
complex one-pole on real input), which is how utils/iirdes.OnePoleCascade
evaluates Butterworth cascades.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .constants import jnp_const

__all__ = ["linrec", "linrec_ref"]

# Chunk length of the blocked scan.  128 was the first target's matrix-unit size;
# it is untuned on the H100.
_DEF_L = 128


@functools.lru_cache(maxsize=None)
def _decay_matrices(a: complex, L: int, is_complex: bool):
    """Static (L, L) lower-triangular decay matrix and the a^(i+1) vector."""
    i = np.arange(L)
    # clamp the (masked-out) upper triangle to exponent 0 so np.power never
    # overflows for |a| < 1 (the values are zeroed by the where anyway)
    expo = np.maximum(i[:, None] - i[None, :], 0)
    T = np.where(i[:, None] >= i[None, :],
                 np.power(complex(a) if is_complex else float(a), expo), 0.0)
    apow = np.power(complex(a) if is_complex else float(a), i + 1)
    dt = np.complex64 if is_complex else np.float32
    return np.asarray(T, dtype=dt), np.asarray(apow, dtype=dt)


def linrec(b: jax.Array, a: complex | float, y0: jax.Array, block: int = _DEF_L) -> jax.Array:
    """Solve y[n] = a·y[n-1] + b[n] for all n, y[-1] = y0.

    ``a`` must be a static Python scalar (filter coefficient), ``b`` a 1-D
    array (float32 or complex64), ``y0`` a scalar array.  Returns y with the
    same shape/dtype promotion of (b, a, y0).
    """
    n = b.shape[0]
    # normalize: a complex-typed pole with zero imaginary part IS a real pole
    # (iirdes partial fractions hand over complex(p) unconditionally; real
    # poles occur for wide bandpass/odd-order designs) — float(a) on a
    # complex raises TypeError, so demote before classifying
    if isinstance(a, complex) and a.imag == 0.0:
        a = a.real
    a_complex = isinstance(a, complex)
    out_complex = a_complex or jnp.iscomplexobj(b) or jnp.iscomplexobj(y0)
    dt = jnp.complex64 if out_complex else jnp.float32
    b = b.astype(dt)
    y0 = jnp.asarray(y0, dtype=dt)

    L = min(block, max(8, n))
    B = -(-n // L)
    pad = B * L - n
    if pad:
        b = jnp.concatenate([b, jnp.zeros((pad,), dtype=dt)])
    bb = b.reshape(B, L)

    # real coefficient ⇒ real decay matrix even for complex forcing: two real
    # matmuls instead of a complex one (DC blocker / AGC on IQ hot path)
    T_np, apow_np = _decay_matrices(complex(a) if a_complex else float(a), L, a_complex)
    T = jnp_const(T_np)
    apow = jnp_const(apow_np).astype(dt)

    # within-block solution with zero carry (one matmul)
    if out_complex and not a_complex:
        w_re = jnp.real(bb) @ T.T
        w_im = jnp.imag(bb) @ T.T
        w = jax.lax.complex(w_re, w_im)
    else:
        w = bb @ T.T  # (B, L); w[k, i] = sum_{j<=i} a^(i-j) b[k, j]

    # block-carry recurrence over B blocks: g[k] = aL·g[k-1] + w[k, L-1]
    aL = apow[-1]  # a^L
    elems_a = jnp.broadcast_to(aL, (B,))
    elems_b = w[:, -1]

    def combine(x, y):
        a1, b1 = x
        a2, b2 = y
        return a1 * a2, a2 * b1 + b2

    acc_a, acc_b = jax.lax.associative_scan(combine, (elems_a, elems_b))
    g = acc_a * y0 + acc_b  # g[k] = y value at end of block k
    g_prev = jnp.concatenate([jnp.reshape(y0, (1,)), g[:-1]])

    y = w + apow[None, :] * g_prev[:, None]
    y = y.reshape(B * L)
    if pad:
        y = y[:n]
    return y


def linrec_ref(b: np.ndarray, a: complex | float, y0: complex | float) -> np.ndarray:
    """Sequential float64/complex128 oracle for tests."""
    y = np.empty(len(b), dtype=np.complex128 if (np.iscomplexobj(b) or isinstance(a, complex)) else np.float64)
    acc = y0
    for i, bi in enumerate(b):
        acc = a * acc + bi
        y[i] = acc
    return y
