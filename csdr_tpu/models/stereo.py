"""FM stereo (pilot-tone) decoder.

Reference: stereoFMDecoder (/root/reference/src/ComposableSDR/Liquid.chs:
1004-1079), constants at :1010-1017 — pilot 19 kHz, PLL bw 9 Hz, pilot FIR
half-band 800 Hz of length quadRate/1350, audio FIRs 15 kHz, de-emphasis
order 2 @ 5 kHz, stereo gain 2, group-delay compensation via Trans.delay.

The reference regenerates the 38 kHz subcarrier with a per-sample PLL
(fmsPll, Liquid.chs:959-1002).  Design: the pilot is already isolated by
the band-pass, so its *analytic phase is available in closed form* — the
subcarrier is (pilot/|pilot|)², computed for every sample in parallel (the
open-loop equivalent of a PLL with the reference's 9 Hz bandwidth; both
reject noise through the same 800 Hz pilot filter).  Everything else is the
same graph: matrix (L+R ± (L−R)), de-emphasis, decimation, interleave.

Input: FM-demodulated composite (real, quad_rate), i.e. downstream of
fmDemodulator 0.8 like the reference's DeFMS flow (apps/SoapySDR.hs:261-264).
Output: (2, n/decim) array — row 0 = L, row 1 = R.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import jax.numpy as jnp

from ..core.block import Block
from ..ops import fir as fir_ops
from ..ops import iir as iir_ops
from ..ops.nco import phase_ramp, phase_increment
from ..utils import firdes, iirdes

__all__ = ["StereoFMDecoder", "stereo_fm_decoder"]

_TWO_PI = 2.0 * np.pi


def fms_pll_scan(p_a: jnp.ndarray, state, omega: float, bw: float):
    """Reference-faithful per-sample pilot PLL (liquid fmsPll,
    Liquid.chs:959-1002): 2nd-order loop tracking the analytic pilot p_a,
    returning the regenerated 38 kHz subcarrier e^{j2φ[n]}.

    This is the serial lax.scan counterpart of the default closed-form
    regeneration — available for fidelity comparisons (`pll_mode='scan'`);
    the open-loop path is the fast default.
    """
    import jax

    alpha = np.float32(4.0 * bw)        # proportional gain
    beta = np.float32(4.0 * bw * bw)    # integrator gain (critically damped-ish)
    omega = np.float32(omega)

    def step(carry, p):
        theta, freq = carry
        rot = jnp.exp(-1j * theta).astype(jnp.complex64)
        e = jnp.angle(p * rot)
        freq = freq + beta * e
        theta_n = theta + omega + freq + alpha * e
        return (jnp.mod(theta_n, np.float32(_TWO_PI)), freq), theta

    (theta, freq), thetas = jax.lax.scan(step, state, p_a)
    sub38 = jnp.exp(2j * thetas).astype(jnp.complex64)
    return (theta, freq), sub38


class StereoFMDecoder(Block):
    def __init__(self, quad_rate: float, decim: int,
                 pilot_hz: float = 19000.0,
                 pilot_fir_halfband_hz: float = 800.0,
                 audio_cutoff_hz: float = 15000.0,
                 deemph_order: int = 2, deemph_cutoff_hz: float = 5000.0,
                 stereo_gain: float = 2.0, pll_mode: str = "closed_form"):
        self.quad_rate = quad_rate
        self.decim = decim
        self.omega19 = _TWO_PI * pilot_hz / quad_rate
        nfir = int(round(quad_rate / 1350.0))
        self.h_pilot = firdes.kaiser_lowpass(nfir, pilot_fir_halfband_hz / quad_rate, 60.0)
        self.h_audio = firdes.kaiser_lowpass(nfir, audio_cutoff_hz / quad_rate, 60.0)
        self.gdelay = int(round(firdes.group_delay(self.h_pilot, 100.0 / quad_rate)))
        self.stereo_gain = stereo_gain
        self.pll_mode = pll_mode
        self.pll_bw = 9.0 / quad_rate  # reference kPLLBandwidthHz = 9 Hz
        self.deemph = iirdes.sos_to_onepole(
            iirdes.butter_sos(deemph_order, deemph_cutoff_hz / quad_rate), real_io=True)
        self.h_decim = (firdes.firdecim_kaiser(decim, 10, 60.0) if decim > 1 else None)
        self.rate = Fraction(1, decim)
        self.granule = decim
        self.name = f"stereo_fm({quad_rate:.0f},{decim})"

    def init(self):
        Kp = len(self.h_pilot)
        Ka = len(self.h_audio)
        st = dict(
            phase19=jnp.zeros((), jnp.float32),
            pilot_hist=jnp.zeros((Kp - 1,), jnp.complex64),
            delay_buf=jnp.zeros((self.gdelay,), jnp.float32),
            lpr_hist=jnp.zeros((Ka - 1,), jnp.float32),
            lmr_hist=jnp.zeros((Ka - 1,), jnp.complex64),
            deemph_l=iir_ops.onepole_cascade_init(self.deemph, False),
            deemph_r=iir_ops.onepole_cascade_init(self.deemph, False),
            pll=(jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32)),
        )
        if self.h_decim is not None:
            Kd = len(self.h_decim)
            st["decim_l"] = jnp.zeros((Kd - 1,), jnp.float32)
            st["decim_r"] = jnp.zeros((Kd - 1,), jnp.float32)
        return st

    def flush_len(self) -> int:
        # the internal group-delay line withholds gdelay composite samples
        # from the audio paths; round up to the decimator granule so the
        # final partial frame is produced too (reference fold `done`,
        # Trans.hs:86-104 — there the delay's leftover pairs flow through
        # the remaining folds; here the runtime's zero-fill pushes the
        # delay_buf through the same internal FIR/de-emph/decim path)
        return -(-self.gdelay // self.decim) * self.decim

    def apply(self, state, c):
        n = int(c.shape[0])
        theta0 = state["phase19"]
        new_phase = jnp.mod(state["phase19"] + phase_increment(self.omega19, n),
                            _TWO_PI)

        def delay_fn(buf, x):
            full = jnp.concatenate([buf, x])
            return full[n:], full[:n]

        def decim_fn(hist, x):
            return fir_ops.fir_decim_stream(self.h_decim, self.decim, hist, x)

        return self._process(state, c, theta0, new_phase,
                             fir_ops.fir_stream, delay_fn,
                             iir_ops.onepole_cascade_stream, decim_fn)

    def _process(self, state, c, theta0, new_phase, fir_fn, delay_fn,
                 deemph_fn, decim_fn):
        """The decode graph with its stateful primitives injected: the serial
        `apply` passes the plain streaming forms; `shard_apply` passes
        ShardCtx-backed ones (halo-exchanged FIR histories, distributed pole
        carries, halo delay) — same math either way."""
        n = c.shape[0]
        s = dict(state)

        # --- pilot extraction: mixDown 19k → LPF (group delay gd) ---
        ramp = jnp.asarray(phase_ramp(self.omega19, int(n)))
        theta = theta0 + ramp
        m19 = c.astype(jnp.complex64) * jnp.exp(-1j * theta).astype(jnp.complex64)
        s["pilot_hist"], pilot_bb = fir_fn(self.h_pilot, s["pilot_hist"], m19)
        s["phase19"] = new_phase

        # analytic pilot at the delayed time base: e^{+jω19(n−gd)}
        gd_phase = np.float32(np.mod(self.omega19 * self.gdelay, _TWO_PI))
        p_a = pilot_bb * jnp.exp(1j * (theta - gd_phase)).astype(jnp.complex64)
        if self.pll_mode == "scan":
            s["pll"], sub38 = fms_pll_scan(p_a, s["pll"], self.omega19, self.pll_bw)
        else:
            u = p_a / (jnp.abs(p_a) + 1e-12)
            sub38 = u * u  # e^{j(2ω19(n−gd)+2θp)} — regenerated 38 kHz subcarrier

        # --- delayed composite (group-delay compensation, Trans.delay) ---
        s["delay_buf"], cd = delay_fn(s["delay_buf"], c)

        # --- L−R: mix down by the subcarrier, 15 kHz LPF, ×2 ---
        lmr_in = cd.astype(jnp.complex64) * jnp.conj(sub38)
        s["lmr_hist"], lmr_bb = fir_fn(self.h_audio, s["lmr_hist"], lmr_in)
        lmr = np.float32(self.stereo_gain) * jnp.real(lmr_bb)

        # --- L+R: 15 kHz LPF of the delayed composite ---
        s["lpr_hist"], lpr = fir_fn(self.h_audio, s["lpr_hist"], cd)

        # --- matrix, de-emphasis, decimation ---
        left = lpr + lmr
        right = lpr - lmr
        s["deemph_l"], left = deemph_fn(self.deemph, s["deemph_l"], left)
        s["deemph_r"], right = deemph_fn(self.deemph, s["deemph_r"], right)
        if self.h_decim is not None:
            s["decim_l"], left = decim_fn(s["decim_l"], left)
            s["decim_r"], right = decim_fn(s["decim_r"], right)
        return s, jnp.stack([left, right])

    # ---- sharded execution (core/sharding protocol) -------------------------
    def shard_apply(self, state, c, ctx):
        """Time-sharded decode: the NCO phase is affine in the global index
        (per-device offsets from a float64 table, like blocks.Mixer), FIR
        histories and the group-delay line ride ppermute halos, and the
        de-emphasis pole carries are reconstructed in closed form
        (ShardCtx.linrec) — the same primitives every other sharded block
        uses, so the full DeFMS graph composes under ShardedChain."""
        from ..ops import nco as nco_ops

        nloc = c.shape[0]
        table = jnp.asarray(nco_ops.phase_table(self.omega19, nloc, ctx.dt))
        theta0 = jnp.mod(state["phase19"] + table[ctx.ti()], np.float32(_TWO_PI))
        new_phase = jnp.mod(
            state["phase19"] + phase_increment(self.omega19, nloc * ctx.dt),
            np.float32(_TWO_PI))

        def delay_fn(buf, x):
            halo = ctx.left_halo(x, buf, self.gdelay)
            cd = jnp.concatenate([halo, x])[:nloc]
            return ctx.from_last_time(x[-self.gdelay:]), cd

        def dist_linrec(v, a, carry):
            y, _, new_carry = ctx.linrec(v, a, carry)
            return y, new_carry

        def deemph_fn(casc, st, x):
            return iir_ops.onepole_cascade_stream(casc, st, x,
                                                  linrec_fn=dist_linrec,
                                                  fir_fn=ctx.fir)

        def decim_fn(hist, x):
            K = len(self.h_decim)
            eff = ctx.left_halo(x, hist, K - 1)
            _, y = fir_ops.fir_decim_stream(self.h_decim, self.decim, eff, x)
            return ctx.from_last_time(x[-(K - 1):]), y

        return self._process(state, c, theta0, new_phase,
                             ctx.fir, delay_fn, deemph_fn, decim_fn)

    def shard_validate(self, nloc, ctx):
        if self.pll_mode == "scan":
            raise NotImplementedError(
                f"{self.name}: pll_mode='scan' is a per-sample feedback loop "
                f"and cannot be time-sharded; use the closed-form default")
        if ctx.dc != 1:
            raise ValueError(
                f"{self.name}: stereo output (2, n) shards over time only — "
                f"use a mesh with ch=1")
        halo = max(len(self.h_pilot) - 1, len(self.h_audio) - 1, self.gdelay,
                   (len(self.h_decim) - 1) if self.h_decim is not None else 0)
        if nloc < halo:
            raise ValueError(
                f"{self.name}: local segment {nloc} shorter than the largest "
                f"halo {halo} — grow block_size or reduce time shards")
        if nloc % self.decim:
            raise ValueError(f"{self.name}: local segment {nloc} not a "
                             f"multiple of decim {self.decim}")
        return nloc // self.decim

    def shard_layout(self, in_layout):
        from ..core.sharding import CH

        return CH  # (2, n') panel: P(None, time) on a ch=1 mesh


def stereo_fm_decoder(quad_rate: float, decim: int, **kw) -> Block:
    return StereoFMDecoder(quad_rate, decim, **kw)
