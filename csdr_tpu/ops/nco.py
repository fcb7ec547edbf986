"""Numerically-controlled oscillator (frequency shift) ops.

Reference behavior: liquid nco_crcf VCO used by mixUp/mixDown and the
channelizer pre-shift (/root/reference/src/ComposableSDR/Liquid.chs:744-866).
mix_down multiplies by e^{-jθ[n]}, mix_up by e^{+jθ[n]}, θ stepping by ω per
sample with the phase carried across blocks.

Design: the per-sample phase ramp mod 2π is precomputed *in float64 numpy*
as a static constant (ω and the block length are static config), so a 2^20
sample block suffers no float32 phase-accumulation error; only the scalar
carried phase is runtime state.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

__all__ = ["phase_ramp", "mix_stream", "phase_increment"]

_TWO_PI = 2.0 * np.pi


@functools.lru_cache(maxsize=None)
def phase_ramp(omega: float, n: int) -> np.ndarray:
    """Static per-sample phases (ω·k mod 2π), float64-accurate, as float32."""
    k = np.arange(n, dtype=np.float64)
    return np.mod(omega * k, _TWO_PI).astype(np.float32)


@functools.lru_cache(maxsize=None)
def phase_increment(omega: float, n: int) -> float:
    """(n·ω) mod 2π as an exact-enough python float (static)."""
    return float(np.mod(np.float64(omega) * n, _TWO_PI))


@functools.lru_cache(maxsize=None)
def phase_table(omega: float, nloc: int, dt: int) -> np.ndarray:
    """Per-device phase offsets for a time-sharded NCO: entry i is
    (ω·nloc·i) mod 2π, float64-accumulated.  Device i of a dt-way time mesh
    starts its local ramp at the carried phase plus this offset — the NCO
    state advance is deterministic in the sample index, so sharding it needs
    no collective at all (core/sharding.py)."""
    i = np.arange(dt, dtype=np.float64)
    return np.mod(np.float64(omega) * nloc * i, _TWO_PI).astype(np.float32)


def mix_stream(phase, x: jnp.ndarray, omega: float, up: bool):
    """Multiply block by e^{±j(phase + ω·k)}; returns (new_phase, y).

    ``phase`` is a scalar float32 array (carried state); ``omega`` is static
    (radians/sample, may be negative); ``up=True`` = mix_up (multiply by
    e^{+jθ}), False = mix_down (e^{-jθ}).
    """
    n = x.shape[0]
    ramp = jnp.asarray(phase_ramp(float(omega), int(n)))
    theta = phase + ramp
    rot = jnp.exp(1j * theta) if up else jnp.exp(-1j * theta)
    y = x * rot.astype(jnp.complex64)
    new_phase = jnp.mod(phase + phase_increment(float(omega), int(n)), _TWO_PI)
    return new_phase, y
