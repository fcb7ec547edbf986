"""Symbol timing recovery and symbol tracking.

Reference blocks: symSyncR (symsync_rrrf kaiser, lf_bw 0.05, 2 samples/symbol
out — /root/reference/src/ComposableSDR/Liquid.chs:244-282), symSyncC
(symsync_crcf rnyquist ARKAISER β=0.5, 32 filters — Liquid.chs:177-242),
symTracker (symtrack_cccf: AGC+sync+EQ, RRC β=0.25, BPSK — Liquid.chs:119-175)
and the composition fmDemWithSync (Liquid.chs:431-437).

liquid implements these as per-sample feedback PLLs — the worst shape for an
accelerator.  This module uses the *block-parallel* equivalent: the symbol-rate
timing tone of |x|² (the classical square-law/cyclostationary estimator —
the open-loop counterpart of the Gardner/ML loop liquid closes per sample)
is measured once per device block (≥ thousands of symbols, far more averaging
than liquid's lf_bw=0.05 loop), unwrapped against the carried estimate, and
all symbols are then interpolated *in parallel* against a polyphase matched
filter bank — two gathers and one reduction instead of a serial loop.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp

from ..core.block import Block, chain
from .. import blocks as B
from ..utils import firdes
from ..ops.constants import jnp_const

__all__ = ["SymSync", "SymSyncScan", "sym_sync_r", "sym_sync_c", "sym_tracker",
           "fm_dem_with_sync"]

_TWO_PI = 2.0 * np.pi


@functools.lru_cache(maxsize=None)
def _interp_bank(k: int, m: int, npfb: int, ftype: str, beta: float) -> np.ndarray:
    """(npfb, 2·m·k+1) fractional-delay matched-filter bank: bank[p, l] =
    g(l − mk + p/npfb) where g is the matched filter at k samp/sym."""
    W = 2 * m * k + 1
    t = (np.arange(W * npfb, dtype=np.float64) - (W * npfb - 1) / 2.0) / npfb
    ts = t / k  # in symbol periods

    if ftype == "kaiser":
        g = np.sinc(ts) * np.kaiser(W * npfb, firdes.kaiser_beta(60.0))
    elif ftype in ("rrc", "rnyquist"):
        # continuous RRC evaluated on the oversampled grid.  (For 'rnyquist'
        # — liquid's approximate root-Kaiser — RRC is the same family the
        # approximation targets; see utils/firdes.root_nyquist_kaiser.)
        b = max(beta, 1e-3)
        g = _rrc_continuous(ts, b)
        g = g / np.max(np.abs(g))
    else:
        raise ValueError(ftype)

    bank = np.zeros((npfb, W), dtype=np.float32)
    # g sampled at t = l - mk + p/npfb  → oversampled index center + (l-mk)*npfb + p
    center = (W * npfb - 1) // 2
    for p in range(npfb):
        idx = center + (np.arange(W) - m * k) * npfb + p
        idx = np.clip(idx, 0, W * npfb - 1)
        bank[p] = g[idx]
    return bank


class SymSync(Block):
    """Block-parallel symbol synchronizer: k samples/symbol in,
    ``out_per_sym`` samples/symbol out (reference sets output rate 2,
    Liquid.chs:269)."""

    def __init__(self, k: int, m: int, beta: float, npfb: int,
                 complex_input: bool, ftype: str, out_per_sym: int = 2,
                 name: str = "symsync"):
        assert k >= 2
        self.k, self.m, self.beta, self.npfb = k, m, beta, npfb
        self.complex_input = complex_input
        self.ftype = ftype
        self.out_per_sym = out_per_sym
        self.rate = Fraction(out_per_sym, k)
        self.granule = k
        # History: filter span + symmetric slack of B+k samples each side.
        # The output count per block is FIXED (static shapes under jit), so a
        # persistent clock-rate offset eps makes |τ| grow ~eps·n per block;
        # slack B lets it roam ±5 symbols before the carry snaps back by
        # whole symbols.  MEASURED slip law (tests/test_symsync_slip.py,
        # ±200/±500 ppm): the first slip comes after the slack fills
        # (~B/eps input samples), after which the steady state is exactly
        # one clean one-symbol slip per k/eps input samples — the physical
        # clock-drift rate, the minimum ANY fixed-output-rate synchronizer
        # can achieve (per-block decode accuracy stays 1.0 through every
        # slip).  Applications needing a longer slip-free horizon than
        # B/eps should raise B (more slack = later first slip; the steady
        # rate is eps-bound either way) — the scan-mode fallback has the
        # same fixed-output constraint and cannot beat it.
        self.B = 5 * k
        self.H = 2 * m * k + 2 * k + 2 * self.B
        self.name = f"{name}(k={k})"

    def init(self):
        dt = jnp.complex64 if self.complex_input else jnp.float32
        return (
            jnp.zeros((self.H,), dtype=dt),   # input history
            jnp.zeros((), jnp.float32),       # carried timing estimate τ̂
            jnp.zeros((), jnp.bool_),         # τ̂ valid?
        )

    @staticmethod
    def _nw(n: int, k: int) -> int:
        return max(1, min(8, n // (64 * k)))  # sub-windows (≥64 symbols each)

    def apply(self, state, x):
        hist, tau_prev, tau_valid = state
        k = self.k
        n = x.shape[0]
        nout = (n // k) * self.out_per_sym
        xfull = jnp.concatenate([hist, x])

        # --- transition-energy timing tone |x[n]−x[n−1]|² (works for both
        # matched-filtered and unshaped NRZ signals, unlike |x|² which is
        # constant for NRZ), estimated per sub-window and fitted with a line
        # so constant clock-rate offsets are tracked within the block (the
        # parallel analogue of liquid's closed timing loop).  The tone peaks
        # at symbol BOUNDARIES; centers sit k/2 later. ---
        d = x[1:] - x[:-1]
        s = jnp.abs(d) ** 2 if self.complex_input else d * d
        s = jnp.concatenate([s[:1], s])  # keep length n for the rotator
        rot = jnp_const(_timing_rotator(k, int(n)))
        z = s.astype(jnp.complex64) * rot
        nw = self._nw(int(n), k)
        wlen = n // nw
        Tw = z[: nw * wlen].reshape(nw, wlen).sum(axis=1)       # (nw,)
        tm, slope, cm, tau_carry = self._fit_line(Tw, int(n), tau_prev, tau_valid)

        y = self._interp(xfull, 0, int(nout), tm, slope, cm, origin=0)
        new_hist = xfull[-self.H:]
        return (new_hist, tau_carry, jnp.ones((), jnp.bool_)), y

    def _fit_line(self, Tw, n: int, tau_prev, tau_valid):
        """Weighted least-squares τ(n) line through the per-window timing
        estimates, plus the bounded end-of-block carry.  All inputs/outputs
        are GLOBAL quantities — under sharding every device evaluates this
        identically from the all-gathered Tw."""
        k = self.k
        nw = Tw.shape[0]
        tau_w = -jnp.angle(Tw) * (k / _TWO_PI)                  # mod k
        # unwrap: first window vs carried estimate, then successive windows
        t0 = jnp.mod(tau_w[0], float(k))
        d0 = jnp.mod(t0 - tau_prev + k / 2.0, float(k)) - k / 2.0
        t0 = jnp.where(tau_valid, tau_prev + d0, t0)
        steps = jnp.mod(tau_w[1:] - tau_w[:-1] + k / 2.0, float(k)) - k / 2.0
        tau_seq = t0 + jnp.concatenate([jnp.zeros((1,), jnp.float32),
                                        jnp.cumsum(steps)])      # (nw,)
        # weighted least-squares line through (window center, tau)
        centers = jnp.asarray((np.arange(nw) + 0.5) * (n // nw), dtype=jnp.float32)
        wgt = jnp.abs(Tw) + 1e-12
        wsum = wgt.sum()
        cm = (wgt * centers).sum() / wsum
        tm = (wgt * tau_seq).sum() / wsum
        var = (wgt * (centers - cm) ** 2).sum() + 1e-6
        slope = jnp.where(nw > 1, (wgt * (centers - cm) * (tau_seq - tm)).sum() / var,
                          jnp.zeros((), jnp.float32))
        slope = jnp.clip(slope, -0.2, 0.2)  # sanity: ≤ 0.2 samples drift/sample

        tau_carry = tm + slope * (np.float32(n) - cm)  # τ at the block end
        # Bounded carry with hysteresis: under a constant sample-clock offset
        # τ otherwise grows without bound across blocks until the gather
        # clamps and output silently corrupts.  Re-centering must NOT happen
        # every block (an unconditional mod-k would slip one symbol at every
        # boundary, corrupting a healthy stream) — only once |τ| exceeds the
        # history slack does it snap back by whole symbols, the same minimal
        # symbol slip a feedback symsync uses to absorb persistent rate error.
        over = jnp.maximum(jnp.abs(tau_carry) - np.float32(self.B), 0.0)
        slip_syms = jnp.ceil(over / np.float32(k))  # 0 while τ is in-slack
        tau_carry = tau_carry - slip_syms * np.float32(k) * jnp.sign(tau_carry)
        return tm, slope, cm, tau_carry

    def _interp(self, ext, j0, nout_local: int, tm, slope, cm, origin):
        """Interpolate output samples j = j0 .. j0+nout_local−1 against the
        polyphase matched-filter bank.  ``ext`` is the available data indexed
        in GLOBAL xfull coordinates minus ``origin`` (serial: ext = xfull,
        origin = 0; sharded: ext = [left halo | local x | right halo],
        origin = ti·nloc).

        Positions are kept as exact int grid points + a SMALL float32
        residual: a single float32 `base + tau` loses the polyphase fraction
        once positions pass ~2^22 (ulp 0.5 ≥ the 1/npfb bank step), silently
        picking wrong fractional-delay filters late in large blocks."""
        k, m, npfb = self.k, self.m, self.npfb
        bank = jnp.asarray(_interp_bank(k, m, npfb, self.ftype, self.beta))
        W = bank.shape[1]
        # constant processing delay, centered in the slack: τ may roam
        # ±(B+k) samples before the interpolation window leaves the data
        start = self.H - (m * k + k + self.B)
        num = (j0 + jnp.arange(nout_local)) * k
        base_int = np.int32(start) + (num // self.out_per_sym).astype(jnp.int32)
        base_frac = ((num % self.out_per_sym).astype(jnp.float32)
                     / np.float32(self.out_per_sym))
        # τ(n) = tm + slope·(n − cm) marks boundaries; centers are k/2 later.
        # (base − cm) may be large but only multiplies the tiny slope — the
        # f32 rounding of base_int there is harmless.
        bdiff = (base_int.astype(jnp.float32) - cm) + base_frac
        delta = tm + slope * bdiff + np.float32(k / 2.0) + base_frac
        dlo = jnp.floor(delta)
        frac = delta - dlo
        ipos = base_int + dlo.astype(jnp.int32) - origin
        ph = jnp.clip(jnp.round(frac * npfb).astype(jnp.int32), 0, npfb - 1)
        offs = jnp.asarray((np.arange(W) - m * k).astype(np.int32))
        win = ext[ipos[:, None] + offs[None, :]]          # (nout, W) gather
        taps = bank[ph]                                   # (nout, W) gather
        return jnp.sum(win * taps.astype(win.dtype), axis=-1)

    # ---- sharded execution (core/sharding protocol) -------------------------
    def shard_apply(self, state, x, ctx):
        """Time-sharded symbol sync with the SAME global math: each device
        sums the timing tone over the global sub-windows it owns (windows
        align with device boundaries — enforced statically), the per-window
        sums are all-gathered over 'time' (nw complex scalars), every device
        evaluates the identical global line fit, and interpolates its own
        outputs against [left halo | local x | right halo]."""
        hist, tau_prev, tau_valid = state
        k = self.k
        nloc = x.shape[0]
        n = nloc * ctx.dt
        nout_loc = (nloc // k) * self.out_per_sym

        d_inner = x[1:] - x[:-1]
        s_inner = jnp.abs(d_inner) ** 2 if self.complex_input else d_inner * d_inner
        # device 0 mirrors the serial block-head duplication; others use the
        # true cross-boundary difference
        prev1 = ctx.left_halo(x, x[:1], 1)
        d0 = x[:1] - prev1
        s0_true = jnp.abs(d0) ** 2 if self.complex_input else d0 * d0
        s0 = jnp.where(ctx.ti() == 0, s_inner[:1], s0_true)
        s = jnp.concatenate([s0, s_inner])
        # the rotator phase offset per device is a multiple of 2π (k | nloc)
        rot = jnp_const(_timing_rotator(k, int(nloc)))
        z = s.astype(jnp.complex64) * rot
        nw = self._nw(int(n), k)
        nw_loc = nw // ctx.dt
        wlen = n // nw
        Tw_loc = z[: nw_loc * wlen].reshape(nw_loc, wlen).sum(axis=1)
        Tw = jax.lax.all_gather(Tw_loc, ctx.time_axis).reshape(nw)

        tm, slope, cm, tau_carry = self._fit_line(Tw, int(n), tau_prev, tau_valid)

        ext = jnp.concatenate([
            ctx.left_halo(x, hist, self.H), x,
            ctx.right_halo(x, self.m * k + self.k + self.B)])
        y = self._interp(ext, ctx.ti() * nout_loc, int(nout_loc),
                         tm, slope, cm, origin=ctx.ti() * nloc)
        new_hist = ctx.from_last_time(x[-self.H:])
        return (new_hist, tau_carry, jnp.ones((), jnp.bool_)), y

    def shard_validate(self, nloc, ctx):
        k = self.k
        n = nloc * ctx.dt
        if nloc % k:
            raise ValueError(f"{self.name}: local segment {nloc} not a "
                             f"multiple of k={k}")
        nw = self._nw(n, k)
        if nw % ctx.dt:
            raise ValueError(
                f"{self.name}: {nw} timing sub-windows cannot align with "
                f"{ctx.dt} time shards — grow block_size (needs ≥ "
                f"{64 * k * ctx.dt} samples) or use dt dividing {nw}")
        wlen = n // nw
        if nloc % wlen:
            raise ValueError(
                f"{self.name}: sub-window length {wlen} does not divide the "
                f"local segment {nloc}")
        halo = max(self.H, self.m * k + k + self.B)
        if nloc < halo:
            raise ValueError(
                f"{self.name}: local segment {nloc} shorter than halo {halo}")
        return (nloc // k) * self.out_per_sym


class SymSyncScan(Block):
    """Closed-loop symbol synchronizer: per-output-tick Gardner TED + PI loop
    via lax.scan — the faithful counterpart of liquid's symsync feedback
    dynamics (Liquid.chs:177-282), for time-VARYING clock drift the windowed
    line fit cannot model.  Serial per output sample; use the block-parallel
    `SymSync` on wideband paths."""

    def __init__(self, k: int, m: int, beta: float, npfb: int,
                 complex_input: bool, ftype: str, lf_bw: float = 0.05,
                 out_per_sym: int = 2, name: str = "symsync_scan"):
        self.k, self.m, self.beta, self.npfb = k, m, beta, npfb
        self.complex_input = complex_input
        self.ftype = ftype
        self.out_per_sym = out_per_sym
        self.rate = Fraction(out_per_sym, k)
        self.granule = k
        self.W = 2 * m * k + 1
        self.H = self.W + 2 * k
        # PI loop gains from the loop bandwidth (reference lf_bw = 0.05).
        # The Gardner error is ~proportional to the timing error in SYMBOL
        # units while τ is carried in SAMPLES — scale kp by k/2 so the loop
        # bandwidth is what lf_bw promises (without this the loop lags by
        # ~k× and loses lock under fast wander).  The integrator scales
        # LINEARLY in k (a squared scale over-drives it into jitter on
        # sharp-transition NRZ signals).
        self.kp = np.float32(2.0 * lf_bw * (k / 2.0))
        self.ki = np.float32(lf_bw * lf_bw * (k / 2.0))
        self.name = f"{name}(k={k})"

    def init(self):
        dt = jnp.complex64 if self.complex_input else jnp.float32
        return (
            jnp.zeros((self.H,), dtype=dt),   # input history
            jnp.zeros((), jnp.float32),        # tau (timing offset, samples)
            jnp.zeros((), jnp.float32),        # eta (loop integrator)
            jnp.zeros((), dt),                 # previous center sample
            jnp.zeros((), dt),                 # pending edge sample
        )

    def apply(self, state, x):
        hist, tau0, eta0, prev_c0, edge0 = state
        k, m, npfb = self.k, self.m, self.npfb
        n = x.shape[0]
        nout = (n // k) * self.out_per_sym
        xfull = jnp.concatenate([hist, x])
        bank = jnp.asarray(_interp_bank(k, m, npfb, self.ftype, self.beta))
        W = bank.shape[1]
        start = self.H - (m * k + k)
        half = k / self.out_per_sym

        def step(carry, j):
            tau, eta, prev_c, edge = carry
            pos = np.float32(start) + j.astype(jnp.float32) * np.float32(half) + tau
            ipos = jnp.floor(pos).astype(jnp.int32)
            frac = pos - ipos.astype(jnp.float32)
            ph = jnp.clip(jnp.round(frac * npfb).astype(jnp.int32), 0, npfb - 1)
            win = jax.lax.dynamic_slice(xfull, (ipos - m * k,), (W,))
            y = jnp.sum(win * bank[ph].astype(win.dtype))
            is_center = (j % 2) == 0

            # Gardner: e = Re(edge · conj(c[n] − c[n−1])) at center ticks
            def ted(args):
                tau_, eta_, prev_c_, edge_ = args
                if self.complex_input:
                    e = jnp.real(edge_ * jnp.conj(y - prev_c_))
                else:
                    e = edge_ * (y - prev_c_)
                # Gardner sign convention: positive e ⇒ sampling late
                e = -jnp.clip(e, -1.0, 1.0)
                eta_n = eta_ + self.ki * e
                tau_n = tau_ + self.kp * e + eta_n
                return tau_n, eta_n, y, edge_

            def hold(args):
                tau_, eta_, prev_c_, _ = args
                return tau_, eta_, prev_c_, y  # store edge sample

            tau, eta, prev_c, edge = jax.lax.cond(
                is_center, ted, hold, (tau, eta, prev_c, edge))
            return (tau, eta, prev_c, edge), y

        (tau, eta, prev_c, edge), ys = jax.lax.scan(
            step, (tau0, eta0, prev_c0, edge0), jnp.arange(nout))
        new_hist = xfull[-self.H:]
        # keep tau bounded (timing wraps are absorbed by ±k/2 re-centering)
        tau = jnp.mod(tau + k / 2.0, np.float32(k)) - k / 2.0
        return (new_hist, tau, eta, prev_c, edge), ys


def sym_sync_r(k: int, m: int = 4, beta: float = 0.0, npfb: int = 64,
               mode: str = "block") -> Block:
    """Real symbol sync (reference symSyncR k m beta nf, kaiser matched
    filter, Liquid.chs:265-272).  mode="scan" selects the closed-loop
    Gardner/PI variant (liquid-faithful dynamics, serial)."""
    cls = SymSyncScan if mode == "scan" else SymSync
    return cls(k, max(m, 1), beta, npfb, complex_input=False, ftype="kaiser",
               name="symsync_r")


def sym_sync_c(m: int, k: int, beta: float = 0.5, npfb: int = 32,
               mode: str = "block") -> Block:
    """Complex symbol sync (reference symSyncC m k: rnyquist ARKAISER β=0.5,
    32 filters, Liquid.chs:223-232).  Argument order (m, k) matches the
    reference export."""
    cls = SymSyncScan if mode == "scan" else SymSync
    return cls(k, max(m, 1), beta, npfb, complex_input=True, ftype="rnyquist",
               name="symsync_c")


def fm_dem_with_sync(k: int) -> Block:
    """NBFM + timing recovery (reference fmDemWithSync, Liquid.chs:431-437):
    fmDemodulator(0.02·k) then symSyncR k 4 0 64 → 2 samples/symbol F32."""
    return chain(B.fm_demodulator(0.02 * k), sym_sync_r(k, 4, 0.0, 64))


class _PowerNCarrierRecovery(Block):
    """Power-N carrier recovery — the block-parallel counterpart of
    symtrack's carrier PLL.  N = 2 removes BPSK modulation (squaring
    estimator), N = 4 removes QPSK/square-QAM modulation, N = 8 for 8PSK.
    The 2π/N phase ambiguity is resolved against the carried estimate (and
    is inherent to the constellation — receivers absorb it with a lag/
    rotation search or differential coding)."""

    def __init__(self, npow: int = 2, ms: str = "bpsk"):
        self.npow = npow
        # the constellation's own power-N moment sets a constant reference
        # angle (e.g. QPSK: Σc⁴ = −1 ⇒ π/4 bias without this correction)
        from .modem import constellation

        mom = np.mean(constellation(ms) ** npow)
        self.ref_angle = np.float32(np.angle(mom)) if abs(mom) > 1e-9 \
            else np.float32(0.0)
        self.name = f"carrier_pow{npow}"

    def init(self):
        return jnp.zeros((), jnp.float32)  # carried phase estimate

    def apply(self, state, y):
        npow = self.npow
        yn = y
        for _ in range(int(np.log2(npow))):
            yn = yn * yn
        ph = (jnp.angle(jnp.sum(yn)) - self.ref_angle) / np.float32(npow)
        amb = np.float32(_TWO_PI / npow)
        d = jnp.mod(ph - state + amb / 2, amb) - amb / 2
        phi = state + d
        out = y * jnp.exp(-1j * phi).astype(jnp.complex64)
        return phi, out


class _PowerNormalize(Block):
    """Normalize symbol-stream power to 1 (EMA-carried): decision-directed
    QAM equalization needs the ring amplitudes on the unit-energy grid —
    sign decisions (PSK) are scale-free, multi-ring decisions are not."""

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha
        self.name = "pwr_norm"

    def init(self):
        return (jnp.ones((), jnp.float32), jnp.zeros((), jnp.bool_))

    def apply(self, state, y):
        p_prev, valid = state
        p_blk = jnp.mean(jnp.abs(y) ** 2) + 1e-12
        p = jnp.where(valid, (1 - self.alpha) * p_prev + self.alpha * p_blk,
                      p_blk)
        out = y * jax.lax.rsqrt(p).astype(jnp.float32)
        return (p, jnp.ones((), jnp.bool_)), out


class _BlockLMSEqualizer(Block):
    """Decision-directed block-NLMS equalizer (symtrack's EQ stage) — the
    'training loop' of this framework.  Symbols are processed in sub-blocks;
    each sub-block is one normalized-LMS gradient step
    w ← w + μ·Yᴴ(d − Yw̄)/(S·E[|Y|²]) computed as one matmul, so the scan
    carries only the tap vector (sub-block length × taps work stays
    parallel)."""

    def __init__(self, ntaps: int = 7, mu: float = 0.25, sub: int = 128,
                 ms: str = "bpsk"):
        self.ntaps = ntaps
        self.mu = mu
        self.sub = sub
        self.ms = ms
        self.name = f"lms_eq({ntaps},{ms})"

    def init(self):
        w = jnp.zeros((self.ntaps,), jnp.complex64).at[self.ntaps // 2].set(1.0)
        return (w, jnp.zeros((self.ntaps - 1,), jnp.complex64))

    def apply(self, state, y):
        w0, hist = state
        T = self.ntaps
        n = y.shape[0]
        S = next(s for s in range(min(self.sub, n), 0, -1) if n % s == 0)
        nsub = n // S
        yfull = jnp.concatenate([hist, y])
        idx = jnp.arange(n)[:, None] + jnp.arange(T)[None, :]
        Y = yfull[idx].reshape(nsub, S, T)
        mu = np.float32(self.mu)

        # Decision-directed: nearest constellation point (models/modem.py);
        # NLMS drives the output onto the unit-energy constellation grid
        from .modem import hard_decision

        def scan_step(w, Yb):
            out = Yb @ jnp.conj(w)
            if self.ms == "bpsk":
                d = jnp.sign(jnp.real(out)).astype(jnp.complex64)
            else:
                _, d = hard_decision(out, self.ms)
            e = d - out
            p = jnp.mean(jnp.abs(Yb) ** 2) + 1e-9
            upd = (jnp.conj(Yb) * e[:, None]).mean(axis=0) / (p * T)
            return w + mu * jnp.conj(upd), out

        w_final, outs = jax.lax.scan(scan_step, w0, Y)
        return (w_final, yfull[-(T - 1):]), outs.reshape(-1)


_CARRIER_POW = {"bpsk": 2, "qpsk": 4, "8psk": 8, "qam16": 4, "qam64": 4}


def sym_tracker(m: int, k: int, beta: float = 0.25, ntaps: int = 7,
                ms: str = "bpsk") -> Block:
    """Full symbol-tracking receiver (reference symTracker m k wrapping
    symtrack_cccf: AGC → timing sync (RRC) → carrier recovery → LMS EQ,
    RRC β=0.25 — Liquid.chs:158-166; the reference hard-codes BPSK ms=21,
    liquid's surface carries the whole modem family honored via ``ms``).
    Outputs one complex sample per symbol; append models/modem.soft_decision
    for (n, bits/sym) max-log LLRs."""
    if ms not in _CARRIER_POW:
        raise ValueError(f"unknown modulation {ms!r}; have {list(_CARRIER_POW)}")
    sync = SymSync(k, max(m, 1), beta, 32, complex_input=True, ftype="rrc",
                   out_per_sym=1, name="symtrack_sync")
    return chain(
        B.AGC(None, bandwidth=0.01, signal_level=1.0),
        sync,
        _PowerNormalize(),
        _PowerNCarrierRecovery(_CARRIER_POW[ms], ms),
        _BlockLMSEqualizer(ntaps, ms=ms),
    )


@functools.lru_cache(maxsize=None)
def _timing_rotator(k: int, n: int) -> np.ndarray:
    return np.exp(-2j * np.pi * np.arange(n) / k).astype(np.complex64)


def _rrc_continuous(ts: np.ndarray, beta: float) -> np.ndarray:
    """Root-raised-cosine impulse response at arbitrary times (in symbols)."""
    out = np.empty_like(ts)
    near0 = np.abs(ts) < 1e-8
    sing = np.abs(np.abs(4.0 * beta * ts) - 1.0) < 1e-8
    safe = ~(near0 | sing)
    tt = ts[safe]
    num = np.sin(np.pi * tt * (1 - beta)) + 4 * beta * tt * np.cos(np.pi * tt * (1 + beta))
    den = np.pi * tt * (1 - (4 * beta * tt) ** 2)
    out[safe] = num / den
    out[near0] = 1.0 - beta + 4.0 * beta / np.pi
    out[sing] = (beta / np.sqrt(2.0)) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta))
    )
    return out
