"""Multi-chip sharded channelized receiver step.

The reference is strictly single-threaded (SURVEY.md §2c); this build's
north star (BASELINE.json) shards the 64-channel channelize+demod pipeline
over a device mesh:

  * axis 'time': the input block is split into contiguous time segments, one
    per device (the sequence-parallel/data-parallel axis).  Every stateful
    stage needs its left neighbor's tail — exchanged with ONE
    `lax.ppermute` halo per stage (NCCL over NVLink between cards).
  * axis 'ch':  the DFT across PFB branches is a matmul against W (nch×nch);
    each device multiplies only its column shard → channels end up sharded
    (the tensor-parallel axis), and the per-channel demod/audio chain runs on
    local channels only.

Recurrences (DC blocker) cross device boundaries exactly: each device solves
with zero carry, the per-device end values are all-gathered ('time' — d
scalars), and the true incoming carry is reconstructed in closed form
(y_in[i] = a^{n·i}·y₀ + Σ_{j<i} a^{n(i−1−j)}·w_end[j]) — the distributed
extension of ops/linrec's blocked algorithm.

The carried global state is replicated; after the step each tail is taken
from the *last* time-device (mask + psum) so streaming across successive
blocks is exact regardless of the mesh shape — verified against the
single-device Pipeline in tests/test_sharding.py.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.sharding import (  # shared decay tables (core/sharding.py):
    _apow_vec, _astep_table, _carry_coef_table,  # host float64-accumulated
)
from ..ops import linrec as linrec_ops
from ..ops import pfb as pfb_ops
from ..ops.nco import phase_ramp, phase_increment
from ..utils.firdes import firdecim_kaiser
from ..ops.constants import jnp_const
from ..core.runtime import CEnc, encode_tree, decode_tree, _encode_host

__all__ = ["ShardedChannelizedFM", "make_mesh"]

_TWO_PI = 2.0 * np.pi


def make_mesh(n_devices: int | None = None, time_axis: int | None = None):
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if time_axis is None:
        # prefer more time-shards than channel-shards: the largest ch factor
        # that still leaves time >= ch (n=8 → 4×2, n=4 → 2×2, n=2 → 2×1)
        ch = 1
        for c in (4, 2, 1):
            if n % c == 0 and n // c >= c:
                ch = c
                break
        time_axis = n // ch
    ch = n // time_axis
    return Mesh(np.asarray(devs).reshape(time_axis, ch), ("time", "ch"))


@dataclass
class ShardedChannelizedFM:
    """dcBlocker → NCO pre-shift → PFB(nch) → per-channel FM demod
    (→ per-channel audio decimator), sharded over Mesh('time','ch')."""

    mesh: Mesh
    nch: int
    block_size: int          # global samples per step
    kf: float = 0.6
    m: int = 7               # PFB taps/branch semi-length (reference spec 7)
    as_db: float = 80.0
    audio_decim: int = 1
    dc_alpha: float = 0.0005
    agc_threshold_db: float | None = None  # per-channel AGC + squelch
    agc_signal_level: float = 1e-3

    def __post_init__(self):
        self.dt = self.mesh.shape["time"]
        self.dc = self.mesh.shape["ch"]
        assert self.nch % self.dc == 0, (self.nch, self.dc)
        self.nloc = self.block_size // self.dt
        assert self.block_size % (self.dt * self.nch * self.audio_decim) == 0
        assert self.nloc % self.nch == 0
        self.nch_loc = self.nch // self.dc
        self.L = 2 * self.m
        self.pfb_halo = self.L * self.nch - 1
        self.fir_taps = (firdecim_kaiser(self.audio_decim, 10, 60.0).astype(np.float32)
                         if self.audio_decim > 1 else None)
        # single-ppermute halo exchange requires each stage's halo to fit in
        # one neighbor segment
        assert self.nloc >= self.pfb_halo, (self.nloc, self.pfb_halo)
        if self.fir_taps is not None:
            f_loc = self.nloc // self.nch
            assert f_loc >= len(self.fir_taps) - 1, (f_loc, len(self.fir_taps))
        self._shmap = jax.shard_map(
            self._local_step,
            mesh=self.mesh,
            in_specs=(P(), P("time")),
            out_specs=(P(), P("ch", "time")),
            check_vma=False,
        )

        # complex-free jit boundary (see core/runtime.CEnc)
        def _enc_step(state_enc, x_enc):
            s, x = decode_tree(state_enc), decode_tree(x_enc)
            s2, y = self._shmap(s, x)
            return encode_tree(s2), y  # audio output is float32 already

        self._step = jax.jit(_enc_step, donate_argnums=(0,))

    # ---- state ------------------------------------------------------------
    def init(self):
        # one jitted program creates and encodes the initial state on device
        return jax.jit(lambda: encode_tree(self._raw_init()))()

    def _raw_init(self):
        K = len(self.fir_taps) - 1 if self.fir_taps is not None else 0
        return dict(
            dc_x=jnp.zeros((1,), jnp.complex64),
            dc_y=jnp.zeros((1,), jnp.complex64),
            phase=jnp.zeros((), jnp.float32),
            pfb_tail=jnp.zeros((self.pfb_halo,), jnp.complex64),
            demod_last=jnp.ones((self.nch,), jnp.complex64),
            fir_tail=jnp.zeros((self.nch, K), jnp.float32),
            agc_lng=jnp.full((self.nch,), np.float32(np.log(1.0 / self.agc_signal_level))),
            agc_above=jnp.zeros((self.nch,), jnp.bool_),
        )

    def input_sharding(self):
        return NamedSharding(self.mesh, P("time"))

    def output_sharding(self):
        return NamedSharding(self.mesh, P("ch", "time"))

    def step(self, state, x):
        """x: (block_size,) complex64 sharded P('time') (or already
        CEnc-encoded) → (state, audio (nch, block/nch/audio_decim) float32
        sharded P('ch','time')).  State is carried in encoded (complex-free)
        form."""
        return self._step(state, _encode_host(x))

    # ---- helpers ----------------------------------------------------------
    def _left_halo(self, x_local, tail_carry, halo: int):
        """Last `halo` samples of the left time-neighbor (device 0 gets the
        carried global tail).  x_local: (..., nloc_like) — 1-D only here."""
        ti = jax.lax.axis_index("time")
        tail = x_local[-halo:]
        left = jax.lax.ppermute(tail, "time", [(j, j + 1) for j in range(self.dt - 1)])
        return jnp.where(ti == 0, tail_carry, left)

    def _from_last_device(self, val):
        """Replicate `val` taken from the last time-device (and ch 0)."""
        ti = jax.lax.axis_index("time")
        ci = jax.lax.axis_index("ch")
        masked = jnp.where(jnp.logical_and(ti == self.dt - 1, ci == 0), val,
                           jnp.zeros_like(val))
        return jax.lax.psum(jax.lax.psum(masked, "time"), "ch")

    # ---- the sharded step -------------------------------------------------
    def _local_step(self, state, x):
        ti = jax.lax.axis_index("time")
        ci = jax.lax.axis_index("ch")
        nloc = self.nloc

        # ---- DC blocker (distributed linear recurrence) ----
        r = 1.0 - self.dc_alpha
        g = np.float32((1.0 + r) / 2.0)
        prev_last = self._left_halo(x, state["dc_x"], 1)
        prev = jnp.concatenate([prev_last, x[:-1]])
        forcing = g * (x - prev)
        w = linrec_ops.linrec(forcing, float(r), jnp.zeros((1,), jnp.complex64)[0])
        w_end = w[-1]
        ends = jax.lax.all_gather(w_end, "time")  # (dt,)
        coef = jnp.asarray(_carry_coef_table(float(r), nloc, self.dt, False))[ti]
        astep = jnp.asarray(_astep_table(float(r), nloc, self.dt, False))[ti]
        y_in = astep * state["dc_y"][0] \
            + jnp.sum(coef.astype(jnp.complex64) * ends)
        apow = jnp.asarray(_apow_vec(float(r), nloc, False))
        xdc = w + apow.astype(jnp.complex64) * y_in
        new_dc_x = self._from_last_device(x[-1:])
        new_dc_y = self._from_last_device(xdc[-1:])

        # ---- NCO pre-shift (global phase from axis index) ----
        omega = pfb_ops.pfb_offset(self.nch)
        ramp = jnp.asarray(phase_ramp(float(omega), nloc))
        delta = np.float32(phase_increment(float(omega), nloc))
        theta = state["phase"] + delta * ti.astype(jnp.float32) + ramp
        xs = xdc * jnp.exp(-1j * theta).astype(jnp.complex64)
        new_phase = jnp.mod(state["phase"] + delta * np.float32(self.dt), _TWO_PI)

        # ---- PFB polyphase + sharded DFT matmul ----
        halo = self._left_halo(xs, state["pfb_tail"], self.pfb_halo)
        xfull = jnp.concatenate([halo[-(self.nch - 1):] if self.nch > 1 else halo[:0], xs])
        F = nloc // self.nch
        v = xfull[: F * self.nch].reshape(F, self.nch)[:, ::-1]
        # branch FIR history from halo: build previous (L−1) frames
        vh_src = jnp.concatenate([halo, xs])  # pfb_halo + nloc samples
        # frames immediately before our segment: take the nch-aligned frames in halo
        prev_frames = vh_src[: (self.L - 1) * self.nch + self.nch - 1]
        vprev = prev_frames[: (self.L - 1) * self.nch].reshape(self.L - 1, self.nch)[:, ::-1]
        taps = jnp.asarray(pfb_ops.pfb_taps(self.nch, self.m, self.as_db))
        vfull = jnp.concatenate([vprev, v], axis=0)
        u = None
        for l in range(self.L):
            seg = vfull[self.L - 1 - l: self.L - 1 - l + F]
            term = seg * taps[l][None, :]
            u = term if u is None else u + term
        W = jnp_const(pfb_ops.pfb_dft_matrix(self.nch))
        Wshard = jax.lax.dynamic_slice_in_dim(W, ci * self.nch_loc, self.nch_loc, axis=1)
        d = (u @ Wshard).T  # (nch_loc, F)
        new_pfb_tail = self._from_last_device(xs[-self.pfb_halo:])

        # ---- optional per-channel AGC + squelch (distributed recurrence) ----
        if self.agc_threshold_db is not None:
            d, new_agc_lng, new_agc_above = self._agc(state, d, ti, ci)
        else:
            new_agc_lng = state["agc_lng"]
            new_agc_above = state["agc_above"]

        # ---- per-channel FM demod (1-frame halo) ----
        audio, new_demod_last = self._demod_with_prev(state, d, ti, ci)

        # ---- optional per-channel audio decimator ----
        audio, new_fir_tail = self._audio_decim(state, audio, ti, ci)

        new_state = dict(
            dc_x=new_dc_x, dc_y=new_dc_y, phase=new_phase,
            pfb_tail=new_pfb_tail, demod_last=new_demod_last,
            fir_tail=new_fir_tail, agc_lng=new_agc_lng, agc_above=new_agc_above,
        )
        return new_state, audio

    def _demod_with_prev(self, state, d, ti, ci):
        """Per-channel FM demod with a 1-frame halo: the previous frame is
        the left time-neighbor's last frame (device 0: the carried
        demod_last).  Returns (audio (nch_loc, F), new demod_last (nch,))."""
        dml = jax.lax.dynamic_slice_in_dim(state["demod_last"], ci * self.nch_loc,
                                           self.nch_loc, axis=0)
        last_frame = jax.lax.ppermute(d[:, -1], "time",
                                      [(jj, jj + 1) for jj in range(self.dt - 1)])
        prev0 = jnp.where(ti == 0, dml, last_frame)
        prevs = jnp.concatenate([prev0[:, None], d[:, :-1]], axis=1)
        audio = jnp.angle(d * jnp.conj(prevs)) * np.float32(1.0 / (_TWO_PI * self.kf))
        # reassemble the full demod_last (nch,) from channel shards
        dl_shards = jax.lax.all_gather(d[:, -1], "ch")  # (dc, nch_loc)
        return audio, self._from_last_device_time_only(dl_shards.reshape(self.nch))

    def _audio_decim(self, state, audio, ti, ci):
        """Optional per-channel decimating FIR with a (K−1)-sample time halo.
        Returns (audio, new fir_tail); pass-through when not configured."""
        if self.fir_taps is None:
            return audio, state["fir_tail"]
        K = len(self.fir_taps)
        ft = jax.lax.dynamic_slice_in_dim(state["fir_tail"], ci * self.nch_loc,
                                          self.nch_loc, axis=0)
        tail = audio[:, -(K - 1):]
        left = jax.lax.ppermute(tail, "time", [(jj, jj + 1) for jj in range(self.dt - 1)])
        hist = jnp.where(ti == 0, ft, left)
        afull = jnp.concatenate([hist, audio], axis=1)
        M = self.audio_decim
        nout = audio.shape[1] // M
        acc = None
        for k in range(K):
            seg = afull[:, K - 1 - k: K - 1 - k + audio.shape[1]:M][:, :nout]
            term = seg * np.float32(self.fir_taps[k])
            acc = term if acc is None else acc + term
        tails = jax.lax.all_gather(audio[:, -(K - 1):], "ch")  # (dc, nch_loc, K-1)
        new_fir_tail = self._from_last_device_time_only(
            tails.reshape(self.nch, K - 1))
        return acc, new_fir_tail

    def _agc(self, state, d, ti, ci):
        """Per-channel AGC + squelch across the time mesh: the log-gain
        recurrence solved locally with zero carry, per-channel end values
        all-gathered over 'time', incoming carries reconstructed in closed
        form (same algebra as the DC blocker; vmapped over local channels).
        Reference behavior: ops/agc.py (liquid agc bw 0.1, level 1e-3,
        pass only steady SIGNALHI samples)."""
        alpha = 0.1
        a = 1.0 - alpha
        nch_loc, F = d.shape
        lng = jax.lax.dynamic_slice_in_dim(state["agc_lng"], ci * self.nch_loc,
                                           self.nch_loc, axis=0)
        prev_above = jax.lax.dynamic_slice_in_dim(
            state["agc_above"], ci * self.nch_loc, self.nch_loc, axis=0)
        b = (-0.5 * alpha) * jnp.log(jnp.abs(d) ** 2 + 1e-30)
        w = jax.vmap(lambda bb: linrec_ops.linrec(bb, float(a),
                                                  jnp.zeros((), jnp.float32)))(b)
        w_end = w[:, -1]                                   # (nch_loc,)
        ends = jax.lax.all_gather(w_end, "time")           # (dt, nch_loc)
        coef = jnp.asarray(_carry_coef_table(float(a), int(F), self.dt, False))[ti]
        astep = jnp.asarray(_astep_table(float(a), int(F), self.dt, False))[ti]
        lng_in = astep * lng \
            + (coef[:, None] * ends).sum(axis=0)           # (nch_loc,)
        apow = jnp.asarray(_apow_vec(float(a), F, False))
        lng_next = w + apow[None, :] * lng_in[:, None]     # ln g[n+1]
        lng_applied = jnp.concatenate([lng_in[:, None], lng_next[:, :-1]], axis=1)
        g = jnp.exp(lng_applied)
        y = d * g.astype(jnp.float32)
        rssi = -lng_applied * np.float32(20.0 / np.log(10.0))
        above = rssi > np.float32(self.agc_threshold_db)
        left_above = jax.lax.ppermute(above[:, -1], "time",
                                      [(jj, jj + 1) for jj in range(self.dt - 1)])
        above0 = jnp.where(ti == 0, prev_above, left_above)
        above_prev = jnp.concatenate([above0[:, None], above[:, :-1]], axis=1)
        y = jnp.where(jnp.logical_and(above, above_prev), y,
                      jnp.zeros((), dtype=y.dtype))
        lng_sh = jax.lax.all_gather(lng_next[:, -1], "ch").reshape(self.nch)
        ab_sh = jax.lax.all_gather(above[:, -1], "ch").reshape(self.nch)
        return y, self._from_last_device_time_only(lng_sh), \
            self._from_last_device_time_only(ab_sh)

    def _from_last_device_time_only(self, val):
        ti = jax.lax.axis_index("time")
        is_bool = val.dtype == jnp.bool_
        if is_bool:
            val = val.astype(jnp.int32)
        masked = jnp.where(ti == self.dt - 1, val, jnp.zeros_like(val))
        s = jax.lax.psum(masked, "time")
        # already identical across 'ch' (all_gather'ed) — divide not needed
        return s > 0 if is_bool else s
