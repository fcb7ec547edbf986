"""Receiver graphs — the composed flows the reference CLI assembles
(/root/reference/apps/SoapySDR.hs:181-283).

Each factory returns a single Block; core/runtime.Pipeline jit-compiles the
whole graph into one device step.  The flagship model is
`channelized_fm_receiver` (BASELINE.json config 5): N-channel PFB split +
per-channel FM demod (+ optional mix-down), the benchmark target.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Block, MixChannels, PerChannel, chain
from .. import blocks as B

__all__ = [
    "front_end",
    "wbfm_receiver",
    "nbfm_receiver",
    "am_receiver",
    "raw_capture",
    "channelized_receiver",
    "channelized_fm_receiver",
]


def front_end(sample_rate: float, offset_hz: float = 0.0, bandwidth: float = 0.0,
              as_db: float = 60.0) -> list[Block]:
    """Offset mixer + resampler, exactly the reference's front end
    (apps/SoapySDR.hs:190-205): f = 2π·offset/fs; offset>0 → mixDown f,
    offset<0 → mixUp −f; resample rate = bandwidth/sample_rate (0 = none)."""
    stages: list[Block] = []
    if offset_hz:
        f = 2.0 * np.pi * offset_hz / sample_rate
        stages.append(B.mix_down(f) if f > 0 else B.mix_up(-f))
    if bandwidth and bandwidth != sample_rate:
        stages.append(B.resampler(bandwidth / sample_rate, as_db))
    return stages


def _agc(threshold_db: float | None) -> list[Block]:
    # `is not None`: 0.0 dB is a legitimate squelch threshold, not "off"
    return ([B.automatic_gain_control(threshold_db)]
            if threshold_db is not None else [])


def wbfm_receiver(sample_rate: float, bandwidth: float, decim: int,
                  offset_hz: float = 0.0, agc_threshold_db: float | None = None) -> Block:
    """CF32 → mono audio at (bandwidth or fs)/decim — the reference's DeWBFM
    flow (apps/SoapySDR.hs:253-260)."""
    quad_rate = bandwidth or sample_rate
    return chain(
        *front_end(sample_rate, offset_hz, bandwidth),
        B.dc_blocker(),
        *_agc(agc_threshold_db),
        B.wbfm_demodulator(quad_rate, decim),
    )


def nbfm_receiver(sample_rate: float, bandwidth: float, kf: float,
                  offset_hz: float = 0.0, agc_threshold_db: float | None = None) -> Block:
    """DeNBFM flow (apps/SoapySDR.hs:245-252)."""
    return chain(
        *front_end(sample_rate, offset_hz, bandwidth),
        B.dc_blocker(),
        *_agc(agc_threshold_db),
        B.fm_demodulator(kf),
    )


def am_receiver(sample_rate: float, bandwidth: float, offset_hz: float = 0.0,
                agc_threshold_db: float | None = None) -> Block:
    """DeAM flow (apps/SoapySDR.hs:265-272)."""
    return chain(
        *front_end(sample_rate, offset_hz, bandwidth),
        B.dc_blocker(),
        *_agc(agc_threshold_db),
        B.am_demodulator(),
    )


def raw_capture(sample_rate: float, bandwidth: float = 0.0, offset_hz: float = 0.0,
                agc_threshold_db: float | None = None) -> Block:
    """DeNo flow: front end + dcBlocker (+AGC), raw CF32 out
    (apps/SoapySDR.hs:237-244)."""
    return chain(
        *front_end(sample_rate, offset_hz, bandwidth),
        B.dc_blocker(),
        *_agc(agc_threshold_db),
    )


def channelized_receiver(nch: int, per_channel: Block | None, mix: bool = False,
                         sample_rate: float = 2.56e6, bandwidth: float = 0.0,
                         offset_hz: float = 0.0,
                         agc_threshold_db: float | None = None) -> Block:
    """PFB split into nch channels with an optional per-channel demod chain;
    mix=True sums demodulated channels into one stream (the reference's
    assembleFold channel paths, apps/SoapySDR.hs:208-226).  Like the
    reference, AGC runs inside the per-channel chain (the `demod` passed to
    assembleFold is `demodChain . agc`)."""
    stages: list[Block] = [
        *front_end(sample_rate, offset_hz, bandwidth),
        B.dc_blocker(),
        B.firpfbch_channelizer(nch),
    ]
    per = chain(*_agc(agc_threshold_db), per_channel) if (
        per_channel is not None and agc_threshold_db is not None) else per_channel
    if per is not None:
        stages.append(PerChannel(per, nch))
    if mix:
        stages.append(MixChannels())
    return chain(*stages)


def channelized_fm_receiver(nch: int, kf: float = 0.6, audio_decim: int = 1,
                            mix: bool = False, **kw) -> Block:
    """The flagship benchmark model (BASELINE.json): nch-channel PFB
    channelize + per-channel FM demod (+ optional audio decimation), one
    XLA graph: dc_blocker → firpfbch_channelizer → PerChannel(fm_demod)."""
    per = B.fm_demodulator(kf) if audio_decim == 1 else chain(
        B.fm_demodulator(kf), B.fir_decimator(audio_decim))
    return channelized_receiver(nch, per, mix=mix, **kw)
