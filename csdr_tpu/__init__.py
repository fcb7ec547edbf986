"""csdr_tpu — a JAX software-defined-radio DSP framework.

Brand-new implementation of the capabilities of composable-sdr
(github.com/mryndzionek/composable-sdr): composable streaming DSP blocks
(polyphase channelizer, arbitrary resampler, FIR/IIR filters, FM/AM/FSK/GMSK
demodulators, AGC+squelch, NCO mixers, stereo FM, symbol sync) expressed as
pure (state, block) → (state, block) JAX transforms, compiled into one jitted
graph, and sharded over device meshes.

This module is the umbrella re-export (reference:
/root/reference/src/ComposableSDR.hs).
"""

import os as _os

import jax as _jax

# Accelerator matmuls may default to reduced-precision operands (TF32 on the
# GPU's tensor cores, bf16 elsewhere) — fine for neural nets, a silent error
# floor for DSP.  A signal-processing framework wants full float32 passes by
# default; override with CSDR_MATMUL_PRECISION=default|high|highest for
# experiments.
_jax.config.update("jax_default_matmul_precision",
                   _os.environ.get("CSDR_MATMUL_PRECISION", "highest"))

from .core.block import Block, Chain, chain, Lambda, Tee, PerChannel, MixChannels, Delay
from .core.runtime import Pipeline, rechunk, take_n
from .blocks import (
    mix_up, mix_down, fm_demodulator, am_demodulator, fsk_demodulator,
    ssb_demodulator, cw_demodulator,
    fir_decimator, fir_interpolator, automatic_gain_control, dc_blocker,
    iir_filter, iir_cfilter, fir_filter, fir_filter_c_kaiser,
    fir_filter_rnyquist, real_to_complex, complex_to_real,
    firpfbch_channelizer, resampler, wbfm_demodulator, u8_to_iq,
)
from .io.sources import (
    cf32_file_source, cu8_file_source, f32_file_source, wav_iq_source,
    raw_bytes_source,
    SdrSource, SyntheticSdrSource, enumerate_devices, open_sdr,
)
from .io.sinks import (
    RawFileSink, StdoutSink, AudioFileSink, ConstellationPlotSink,
    SpectrumPlotSink,
    ChannelFileSinks, NullSink, CollectSink, PlaybackSink, TeeSink,
    BranchSinks,
)

__version__ = "0.1.0"
