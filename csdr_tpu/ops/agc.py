"""Automatic gain control with squelch — fully parallel on the device.

Reference behavior (liquid agc_crcf + the Haskell per-sample squelch loop,
/root/reference/src/ComposableSDR/Liquid.chs:693-717): bandwidth 0.1, signal
level 1e-3, squelch threshold from the CLI, timeout 1000; every sample whose
squelch status is not SIGNALHI is zeroed.

Design — no per-sample loop:
  * the log-domain gain recurrence
        ln g[n+1] = (1−α)·ln g[n] − (α/2)·ln(|x[n]|² + ε)
    is a first-order linear recurrence → ops/linrec.py (blocked matmuls);
  * rssi[n] = −20·log10(g[n]) (liquid's estimate once the loop converges);
  * the reference only passes samples in steady SIGNALHI, i.e. samples whose
    rssi exceeds the threshold *and* whose predecessor did too (the RISE
    sample has status 2); both conditions are vectorized.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .linrec import linrec

__all__ = ["agc_init", "agc_stream", "agc_shard_stream"]

_LN10_OVER_20 = np.log(10.0) / 20.0


def agc_init(signal_level: float = 1e-3):
    """Carried state: (ln_gain, prev_above) — gain initialised to 1/level as
    liquid does from agc_crcf_set_signal_level."""
    return (
        jnp.asarray(np.log(1.0 / signal_level), dtype=jnp.float32),
        jnp.zeros((), dtype=jnp.bool_),
    )


def agc_stream(state, x: jnp.ndarray, bandwidth: float = 0.1,
               squelch_threshold_db: float | None = None):
    """Apply AGC to one block; returns (new_state, y).

    ``squelch_threshold_db``: None disables squelch (output never zeroed).
    """
    ln_g, prev_above = state
    alpha = float(bandwidth)
    a = 1.0 - alpha
    e2 = jnp.abs(x) ** 2
    b = (-0.5 * alpha) * jnp.log(e2 + 1e-30)
    ln_g_next = linrec(b.astype(jnp.float32), a, ln_g)  # ln g[n+1] for each n
    ln_gains = jnp.concatenate([ln_g[None], ln_g_next[:-1]])  # g applied at n
    g = jnp.exp(ln_gains)
    y = x * g.astype(x.dtype if not jnp.iscomplexobj(x) else jnp.float32)

    if squelch_threshold_db is not None:
        rssi = -ln_gains / np.float32(_LN10_OVER_20)  # −20·log10(g)
        above = rssi > np.float32(squelch_threshold_db)
        above_prev = jnp.concatenate([prev_above[None], above[:-1]])
        keep = jnp.logical_and(above, above_prev)
        y = jnp.where(keep, y, jnp.zeros((), dtype=y.dtype))
        new_prev = above[-1]
    else:
        new_prev = prev_above
    return (ln_g_next[-1], new_prev), y


def agc_shard_stream(state, x: jnp.ndarray, ctx, bandwidth: float = 0.1,
                     squelch_threshold_db: float | None = None):
    """Time-sharded AGC + squelch: the log-gain recurrence runs distributed
    (ShardCtx.linrec — the incoming per-device carry gives the gain applied
    at the device's first sample), and the squelch's previous-sample 'above'
    indicator crosses the device boundary as a 1-sample halo."""
    ln_g, prev_above = state
    alpha = float(bandwidth)
    a = 1.0 - alpha
    e2 = jnp.abs(x) ** 2
    b = (-0.5 * alpha) * jnp.log(e2 + 1e-30)
    ln_g_next, lng_in, new_lng = ctx.linrec(b.astype(jnp.float32), a, ln_g)
    ln_gains = jnp.concatenate([jnp.reshape(lng_in, (1,)), ln_g_next[:-1]])
    g = jnp.exp(ln_gains)
    y = x * g.astype(x.dtype if not jnp.iscomplexobj(x) else jnp.float32)

    if squelch_threshold_db is not None:
        rssi = -ln_gains / np.float32(_LN10_OVER_20)
        above = rssi > np.float32(squelch_threshold_db)
        above0 = ctx.left_halo(above, jnp.reshape(prev_above, (1,)), 1)
        above_prev = jnp.concatenate([above0, above[:-1]])
        keep = jnp.logical_and(above, above_prev)
        y = jnp.where(keep, y, jnp.zeros((), dtype=y.dtype))
        new_prev = ctx.from_last_time(above[-1])
    else:
        new_prev = prev_above
    return (new_lng, new_prev), y
