"""Streaming FIR convolution engines.

The reference delegates every FIR to liquid-dsp's per-sample dot products
(firfilt/firdecim/firinterp execute_block — /root/reference/src/ComposableSDR/
Liquid.chs:471-501, 868-957).  Here we operate on large blocks with explicit
carried history ("filter tail") so the streaming semantics are exact:

    y[n] = sum_k h[k] · x[n - k]          (causal, liquid firfilt semantics)

with x indexed over the infinite input stream; the last (K-1) input samples are
carried between blocks in the state pytree.

Three execution strategies:
  * "slices":  K statically-unrolled shifted fused multiply-adds — best for
               short filters.
  * "fft":     batched overlap-save FFT segments — best for long filters; the
               segment FFTs are batched so XLA tiles them efficiently.
  * "auto":    picks by tap count.

Decimating and interpolating variants reshape to polyphase so no multiply is
wasted on discarded outputs.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .constants import jnp_const

__all__ = [
    "conv_valid",
    "fir_stream",
    "fir_decim_stream",
    "fir_interp_stream",
]

_FFT_MIN_TAPS = 64


def _conv_valid_slices(xfull: jnp.ndarray, taps: np.ndarray) -> jnp.ndarray:
    """y[i] = sum_k taps[k] * xfull[i + K - 1 - k],  i in [0, n)."""
    K = len(taps)
    n = xfull.shape[0] - K + 1
    acc = None
    for k in range(K):
        t = taps[k]
        if t == 0.0:  # half-band filters: skip exact-zero taps
            continue
        seg = xfull[K - 1 - k : K - 1 - k + n]
        term = seg * t
        acc = term if acc is None else acc + term
    if acc is None:
        acc = jnp.zeros((n,), dtype=xfull.dtype)
    return acc


def _conv_valid_fft(xfull: jnp.ndarray, taps: np.ndarray, seg: int = 16384) -> jnp.ndarray:
    """Batched overlap-save: segments of length S with K-1 overlap."""
    K = len(taps)
    n = xfull.shape[0] - K + 1
    S = max(seg, 1 << int(np.ceil(np.log2(4 * K))))
    hop = S - (K - 1)
    nseg = -(-n // hop)
    total = (nseg - 1) * hop + S
    pad = total - xfull.shape[0]
    if pad > 0:
        xfull = jnp.concatenate([xfull, jnp.zeros((pad,), dtype=xfull.dtype)])
    # (nseg, S) overlapping view via static gather-free strided construction
    idx = (np.arange(nseg)[:, None] * hop + np.arange(S)[None, :]).astype(np.int32)
    segs = xfull[idx]

    complex_in = jnp.iscomplexobj(xfull) or np.iscomplexobj(taps)
    if complex_in:
        H = np.fft.fft(np.asarray(taps, dtype=np.complex128), S).astype(np.complex64)
        Y = jnp.fft.ifft(jnp.fft.fft(segs, axis=-1) * jnp_const(H)[None, :], axis=-1)
        if not jnp.iscomplexobj(xfull):
            # real data, complex taps: caller keeps complex output
            pass
    else:
        H = np.fft.rfft(np.asarray(taps, dtype=np.float64), S).astype(np.complex64)
        Y = jnp.fft.irfft(jnp.fft.rfft(segs, axis=-1) * jnp_const(H)[None, :], n=S, axis=-1)
    y = Y[:, K - 1 :].reshape(-1)[:n]
    out_dtype = jnp.complex64 if complex_in else xfull.dtype
    return y.astype(out_dtype)


def _auto_strategy(taps: np.ndarray) -> str:
    """Default strategy: short filters run as unrolled FMAs, long ones
    overlap-save through XLA's FFT (cuFFT on the GPU) on every platform."""
    nz = int(np.count_nonzero(taps))
    return "slices" if nz <= _FFT_MIN_TAPS else "fft"


def conv_valid(xfull: jnp.ndarray, taps: np.ndarray, strategy: str = "auto") -> jnp.ndarray:
    """Causal valid convolution: input length n + K - 1 → output length n.

    Strategies: "slices" (unrolled FMAs), "fft" (batched overlap-save),
    "auto".
    """
    taps = np.asarray(taps)
    if strategy == "auto":
        strategy = _auto_strategy(taps)
    if strategy == "slices":
        return _conv_valid_slices(xfull, taps)
    if strategy == "fft":
        return _conv_valid_fft(xfull, taps)
    raise ValueError(f"unknown strategy {strategy!r}")


def fir_stream(taps: np.ndarray, hist: jnp.ndarray, x: jnp.ndarray, strategy: str = "auto"):
    """Same-rate streaming FIR.  hist has length K-1 (past inputs); returns
    (new_hist, y) with len(y) == len(x)."""
    K = len(taps)
    if K == 1:
        return hist, x * taps[0]
    xfull = jnp.concatenate([hist, x])
    y = conv_valid(xfull, taps, strategy)
    return xfull[-(K - 1) :], y


def fir_decim_stream(taps: np.ndarray, M: int, hist: jnp.ndarray, x: jnp.ndarray,
                     strategy: str = "auto"):
    """Decimating FIR: y[m] = sum_k h[k] · x[m·M - k] (stream-indexed).

    len(x) must be a multiple of M; len(y) = len(x)/M.  Polyphase evaluation:
    phase p of h sees the input sub-stream with stride M, so no multiply is
    spent on discarded outputs.
    """
    taps = np.asarray(taps)
    K = len(taps)
    n = x.shape[0]
    assert n % M == 0, (n, M)
    nout = n // M
    xfull = jnp.concatenate([hist, x])  # length n + K - 1
    if strategy == "auto":
        strategy = "poly" if np.count_nonzero(taps) <= 4 * _FFT_MIN_TAPS else "fft"
    if strategy == "fft":
        y = _conv_valid_fft(xfull, taps)[::M]
    else:
        # polyphase: y[m] = Σ_p Σ_l h[p + lM] · xfull[(K-1) + mM - p - lM]
        c = K - 1
        acc = None
        for p in range(M):
            hp = taps[p::M]
            if not np.count_nonzero(hp):
                continue
            d, r = divmod(c - p, M)
            # v[i] = xfull[i·M + r]; need v[m + d - l] for l in range(len(hp))
            v = xfull[r::M]
            for l, t in enumerate(hp):
                if t == 0.0:
                    continue
                # l ≤ len(hp)-1 = floor((K-1-p)/M) = d, so start ≥ 0 always:
                # the K-1 carried samples cover every phase's deepest tap
                start = d - l
                seg = v[start : start + nout]
                term = seg * t
                acc = term if acc is None else acc + term
        y = acc if acc is not None else jnp.zeros((nout,), dtype=xfull.dtype)
    return xfull[-(K - 1) :] if K > 1 else hist, y


def fir_interp_stream(taps: np.ndarray, P: int, hist: jnp.ndarray, x: jnp.ndarray):
    """Interpolating FIR (zero-stuff by P then filter):
    y[m] = sum_k h[k] · u[m - k],  u[mP] = x[m] else 0.

    Polyphase: y[mP + p] = sum_l h[p + lP] · x[m - l].  hist length is
    ceil(K/P) - 1 input samples; len(y) = P·len(x).
    """
    taps = np.asarray(taps)
    K = len(taps)
    Lsub = -(-K // P)  # taps per phase (max)
    n = x.shape[0]
    xfull = jnp.concatenate([hist, x]) if Lsub > 1 else x
    phases = []
    for p in range(P):
        hp = taps[p::P]
        acc = None
        for l, t in enumerate(hp):
            if t == 0.0:
                continue
            seg = xfull[Lsub - 1 - l : Lsub - 1 - l + n]
            term = seg * t
            acc = term if acc is None else acc + term
        if acc is None:
            acc = jnp.zeros((n,), dtype=xfull.dtype)
        phases.append(acc)
    y = jnp.stack(phases, axis=1).reshape(n * P)
    new_hist = xfull[-(Lsub - 1) :] if Lsub > 1 else hist
    return new_hist, y
