"""Polyphase filterbank (PFB) analysis channelizer.

Reference behavior: liquid firpfbch_crcf analyzer, driven one nch-sample frame
per C call with a Haskell transpose loop around it
(/root/reference/src/ComposableSDR/Liquid.chs:811-866).  The channelizer is
preceded by an NCO pre-shift of −0.5·(nch−1)/nch·2π so the nch output channels
tile the spectrum in increasing frequency order (Liquid.chs:817).

Design: the whole block of F frames is processed at once —

  1. polyphase split: v[i, p] = x[i·nch − p]  (one reshape + reverse),
  2. per-branch FIR along the frame axis (L ≈ 14 taps, statically unrolled
     fused multiply-adds on (F, nch) panels),
  3. DFT across branches as an (F, nch) @ (nch, nch) complex matmul.

Channel k (after the standard pre-shift) is centered at
2π·(k − (nch−1)/2)/nch, i.e. channels run from the bottom of the band to the
top.  Derivation: d_k[i] = Σ_m h[m]·x[i·nch−m]·e^{+j2πkm/nch}, the critically
sampled DFT filterbank identity.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from ..utils.firdes import pfb_kaiser_prototype
from .constants import jnp_const

__all__ = ["pfb_taps", "pfb_dft_matrix", "pfb_analyze_init", "pfb_analyze_stream", "pfb_offset"]


def pfb_offset(nch: int) -> float:
    """NCO pre-shift frequency in rad/sample (reference Liquid.chs:817)."""
    return -0.5 * (nch - 1) / nch * 2.0 * np.pi


@functools.lru_cache(maxsize=None)
def pfb_taps(nch: int, m: int = 7, as_db: float = 80.0) -> np.ndarray:
    """(L, nch) polyphase tap matrix, L = 2·m taps per branch; branch p holds
    h[l·nch + p].  Prototype normalized to unity channel gain (Σh = 1)."""
    h = pfb_kaiser_prototype(nch, m, as_db)
    h = h / h.sum()
    L = len(h) // nch
    return h.reshape(L, nch).astype(np.float32)


@functools.lru_cache(maxsize=None)
def pfb_dft_matrix(nch: int) -> np.ndarray:
    """(nch, nch) matrix W[p, k] = e^{+j·2π·k·p/nch} (un-normalized IDFT)."""
    p = np.arange(nch)
    return np.exp(2j * np.pi * np.outer(p, p) / nch).astype(np.complex64)


def pfb_analyze_init(nch: int, m: int = 7):
    L = 2 * m
    return (
        jnp.zeros((nch - 1,), dtype=jnp.complex64),      # tail of previous frame
        jnp.zeros((L - 1, nch), dtype=jnp.complex64),    # branch FIR history (frames)
    )


def pfb_analyze_stream(state, x: jnp.ndarray, nch: int, m: int = 7, as_db: float = 80.0):
    """Channelize one block.  len(x) must be a multiple of nch.
    Returns (new_state, y) with y shape (nch, F), F = len(x)//nch —
    channels-leading contiguous layout exactly like the reference's
    per-channel output arrays (Liquid.chs:837-862)."""
    hist_x, hist_v = state
    n = x.shape[0]
    F = n // nch
    taps = pfb_taps(nch, m, as_db)  # (L, nch)
    L = taps.shape[0]

    # v[i, p] = x[i·nch − p]  → reversed frames of [hist_x | x]
    xfull = jnp.concatenate([hist_x, x])           # length n + nch − 1
    v = xfull[: F * nch].reshape(F, nch)[:, ::-1]  # (F, nch)

    # branch FIR along frames: u[i, p] = Σ_l taps[l, p] · v[i−l, p]
    vfull = jnp.concatenate([hist_v, v], axis=0)   # (F + L − 1, nch)
    u = None
    for l in range(L):
        seg = vfull[L - 1 - l : L - 1 - l + F]
        t = jnp.asarray(taps[l])[None, :]
        term = seg * t
        u = term if u is None else u + term

    W = jnp_const(pfb_dft_matrix(nch))
    d = u @ W  # (F, nch) complex matmul

    new_state = (xfull[F * nch :], vfull[F:])
    return new_state, d.T  # (nch, F)
