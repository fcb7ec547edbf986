"""Sharding-aware Block execution — the generic multi-chip protocol.

The reference's defining property is that *any* composition of Pipes works
(/root/reference/src/ComposableSDR/Types.hs:93-103).  This build's
equivalent: any composition of Blocks *shards*.  Every Block may implement

    shard_apply(state, x_local, ctx) -> (new_state, y_local)

— the same pure math as ``apply``, evaluated on this device's contiguous time
segment, with the cross-device coupling expressed through the small set of
collective helpers on :class:`ShardCtx`:

  * ``left_halo``  — the last ``h`` samples of the left time-neighbor
    (``lax.ppermute`` over the 'time' mesh axis; device 0 receives the carried
    global tail), which for tail-state blocks (FIR & friends) *is* the
    sequential carried state;
  * ``linrec``     — a distributed first-order linear recurrence: local solve
    with zero carry, per-device end values all-gathered over 'time', incoming
    carries reconstructed in closed form (the multi-device extension of
    ops/linrec's blocked algorithm; works for real and complex poles);
  * ``from_last_time`` — a value taken from the *last* time device and
    replicated (mask + psum), used for every carried-state update so streaming
    across successive global blocks stays exact on any mesh shape.

Carried state is replicated across the mesh (PartitionSpec ()); data flows
time-sharded P('time') as 1-D streams and, after a channelizer, P('ch','time')
as (nch, frames) panels.  ``shard_validate`` walks a graph statically (no
jnp ops) checking
halo/granule divisibility and propagating the layout used to build the
shard_map out_specs.

Blocks with inherently sequential per-sample feedback (symsync scan mode, the
scan PLL) raise NotImplementedError from shard_validate: they cannot be
time-sharded, by math rather than by implementation.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["ShardCtx", "Layout", "TIME", "CH"]

# layout tags for data flowing through a sharded chain
TIME = "time"   # 1-D stream, sharded P(time_axis), replicated over ch
CH = "ch"       # (nch, frames) panel, sharded P(ch_axis, time_axis)
Layout = Any    # a tag or a pytree of tags (Tee outputs)


@functools.lru_cache(maxsize=None)
def _apow_vec(a: complex, n: int, is_complex: bool) -> np.ndarray:
    """Host-precomputed a^(i+1), i in [0, n) — the particular-solution decay."""
    p = np.power(complex(a) if is_complex else float(a), np.arange(1, n + 1))
    return p.astype(np.complex64 if is_complex else np.float32)


@functools.lru_cache(maxsize=None)
def _astep_table(a: complex, nloc: int, dt: int, is_complex: bool) -> np.ndarray:
    """Host-precomputed a^(i·nloc) for i in [0, dt) (float64/complex128
    accumulated) — per-device decay of the incoming carry."""
    p = np.power(complex(a) if is_complex else float(a),
                 np.arange(dt, dtype=np.float64) * nloc)
    return p.astype(np.complex64 if is_complex else np.float32)


@functools.lru_cache(maxsize=None)
def _carry_coef_table(a: complex, nloc: int, dt: int, is_complex: bool) -> np.ndarray:
    """(dt, dt) table C[i, j] = a^(nloc·(i−1−j)) for j < i else 0: the weight
    of device j's local end value in device i's incoming carry."""
    i = np.arange(dt)[:, None]
    j = np.arange(dt)[None, :]
    expo = np.maximum((i - 1 - j) * nloc, 0).astype(np.float64)
    base = complex(a) if is_complex else float(a)
    C = np.where(j < i, np.power(base, expo), 0.0)
    return C.astype(np.complex64 if is_complex else np.float32)


class ShardCtx:
    """Collective helpers available inside a sharded Block step.

    Constructed by parallel/generic.ShardedChain once per shard_map trace;
    ``layout`` is mutated by Chain as it walks the graph (each block's
    ``shard_layout`` declares its output layout).
    """

    def __init__(self, dt: int, dc: int, time_axis: str = "time",
                 ch_axis: str = "ch", layout: Layout = TIME):
        self.dt = dt
        self.dc = dc
        self.time_axis = time_axis
        self.ch_axis = ch_axis
        self.layout = layout
        # True while executing inside PerChannel's vmap (collectives are then
        # batched over the local-channel axis)
        self.in_channel_lane = False
        # True when the runner honors Block.shard_state_spec: "ch"-tagged
        # state leaves arrive channel-LOCAL (this device's rows only), so
        # PerChannel skips its slice/all-gather (parallel/generic sets it)
        self.state_local = False

    def clone(self, **kw) -> "ShardCtx":
        c = ShardCtx(self.dt, self.dc, self.time_axis, self.ch_axis, self.layout)
        c.in_channel_lane = self.in_channel_lane
        c.state_local = self.state_local
        for k, v in kw.items():
            setattr(c, k, v)
        return c

    # ---- axis indices ------------------------------------------------------
    def ti(self):
        return jax.lax.axis_index(self.time_axis)

    def ci(self):
        if self.dc == 1:
            return jnp.zeros((), jnp.int32)
        return jax.lax.axis_index(self.ch_axis)

    # ---- halo exchange -----------------------------------------------------
    def left_halo(self, x: jnp.ndarray, carried_tail: jnp.ndarray, h: int):
        """Last ``h`` samples (leading axis) preceding this device's segment:
        the right tail of the left time-neighbor; device 0 gets the carried
        global tail.  Generic over dtype (bools ride as-is)."""
        if self.dt == 1:
            return carried_tail
        tail = x[-h:] if h > 0 else x[:0]
        left = jax.lax.ppermute(tail, self.time_axis,
                                [(j, j + 1) for j in range(self.dt - 1)])
        ti = self.ti()
        return jnp.where(ti == 0, carried_tail, left)

    def right_halo(self, x: jnp.ndarray, r: int):
        """First ``r`` samples of the RIGHT time-neighbor's segment (the
        stream's immediate future — available inside the same global block).
        The last device, which has no right neighbor, gets its own final
        sample edge-replicated — matching the clamped-gather behavior a
        single device shows at the end of xfull."""
        if r <= 0:
            return x[:0]
        edge = jnp.broadcast_to(x[-1:], (r,) + x.shape[1:])
        if self.dt == 1:
            return edge
        head = x[:r]
        right = jax.lax.ppermute(head, self.time_axis,
                                 [(j + 1, j) for j in range(self.dt - 1)])
        ti = self.ti()
        return jnp.where(ti == self.dt - 1, edge, right)

    # ---- carried-state updates --------------------------------------------
    def from_last_time(self, val: jnp.ndarray):
        """``val`` as computed on the last time device, replicated over
        'time' (psum of a one-hot mask).  Bool-safe."""
        if self.dt == 1:
            return val
        ti = self.ti()
        is_bool = val.dtype == jnp.bool_
        v = val.astype(jnp.int32) if is_bool else val
        masked = jnp.where(ti == self.dt - 1, v, jnp.zeros_like(v))
        s = jax.lax.psum(masked, self.time_axis)
        return s > 0 if is_bool else s

    # ---- distributed linear recurrence ------------------------------------
    def linrec(self, forcing: jnp.ndarray, a: complex | float, carry0: jnp.ndarray):
        """Solve y[n] = a·y[n−1] + forcing[n] across the time mesh.

        ``forcing``: (nloc,) local segment; ``carry0``: scalar global incoming
        carry (y[-1] of the whole stream), replicated.  Returns
        ``(y_local, y_in, new_carry)`` — the local solution, the incoming
        carry *for this device* (= y just before the local segment; the AGC
        needs it for its applied-gain alignment), and the end-of-global-block
        carry (replicated) for the next streaming step.

        Math (the multi-device layer of ops/linrec's blocked algorithm):
        every device solves locally with zero carry (w), the per-device end
        values w_end are all-gathered (dt scalars), and device i's
        true incoming carry is reconstructed in closed form:

            y_in[i] = a^(i·nloc)·carry0 + Σ_{j<i} a^(nloc·(i−1−j))·w_end[j]
        """
        from ..ops import linrec as linrec_ops

        nloc = forcing.shape[0]
        # demote complex-typed-but-real poles (imag == 0) like ops/linrec:
        # the _apow/_astep/_carry tables call float(a) on the real branch
        if isinstance(a, complex) and a.imag == 0.0:
            a = a.real
        a_complex = isinstance(a, complex)
        out_complex = a_complex or jnp.iscomplexobj(forcing) or jnp.iscomplexobj(carry0)
        dtt = jnp.complex64 if out_complex else jnp.float32
        zero = jnp.zeros((), dtype=dtt)
        w = linrec_ops.linrec(forcing.astype(dtt), a, zero)
        if self.dt == 1:
            y = w + jnp.asarray(_apow_vec(a, nloc, a_complex)).astype(dtt) \
                * jnp.asarray(carry0, dtype=dtt)
            return y, jnp.asarray(carry0, dtype=dtt), y[-1]
        ti = self.ti()
        w_end = w[-1]
        ends = jax.lax.all_gather(w_end, self.time_axis)         # (dt,)
        C = jnp.asarray(_carry_coef_table(a, nloc, self.dt, a_complex))
        astep = jnp.asarray(_astep_table(a, nloc, self.dt, a_complex))
        coef = C[ti]                                             # (dt,)
        y_in = astep[ti].astype(dtt) * jnp.asarray(carry0, dtype=dtt) \
            + jnp.sum(coef.astype(dtt) * ends)
        apow = jnp.asarray(_apow_vec(a, nloc, a_complex)).astype(dtt)
        y = w + apow * y_in
        new_carry = self.from_last_time(y[-1])
        return y, y_in, new_carry

    # ---- sharded FIR building block ---------------------------------------
    def fir(self, taps: np.ndarray, hist: jnp.ndarray, x: jnp.ndarray,
            strategy: str = "auto"):
        """Sharded counterpart of ops/fir.fir_stream: the (K−1)-sample history
        comes from the left neighbor instead of the carried state; the new
        carried history is the last device's input tail."""
        from ..ops.fir import fir_stream

        K = len(taps)
        if K == 1:
            return hist, x * taps[0]
        h = K - 1
        eff = self.left_halo(x, hist, h)
        _, y = fir_stream(taps, eff, x, strategy)
        return self.from_last_time(x[-h:]), y
