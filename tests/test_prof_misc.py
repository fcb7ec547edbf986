"""Profiling utilities + the XLA flagship graph under a profiled Pipeline."""

import numpy as np

import jax
import jax.numpy as jnp

import csdr_tpu as cs
from csdr_tpu.utils.prof import Meter, timed_steps
from csdr_tpu.core.runtime import Pipeline
from csdr_tpu.models.receivers import channelized_fm_receiver


def test_meter():
    m = Meter("x")
    m.start()
    m.tick(1000)
    m.tick(1000)
    assert m.samples == 2000
    assert m.msps > 0
    assert "x:" in m.report()


def test_timed_steps():
    blk = cs.fm_demodulator(0.6)
    step = jax.jit(blk.apply)
    st = blk.init()
    x = jnp.ones((4096,), jnp.complex64)
    dt, st = timed_steps(step, st, x, iters=3)
    assert dt > 0


def test_flagship_fused_in_pipeline():
    """The flagship graph (dc_blocker → PFB → per-channel FM demod) under
    Pipeline(profile=True): one budget row per stage, and the same output
    as the fused single-jit step."""
    nch, frames = 8, 64
    blk = channelized_fm_receiver(nch, kf=0.6)
    assert blk.granule == nch
    n = nch * frames * 4
    rng = np.random.default_rng(0)
    iq = (0.1 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)

    pipe = Pipeline(blk, block_size=nch * frames * 2, donate=False,
                    profile=True)
    sink = cs.CollectSink()
    total = pipe.run(iter([iq]), sink)
    assert total == n // nch
    out = sink.concat()
    assert out.shape == (nch, n // nch)
    assert [s.name for s in pipe.stage_stats] == [
        "dc_blocker", f"pfb_channelizer({nch})", pipe.stage_stats[2].name]
    assert all(s.calls == 2 for s in pipe.stage_stats)
    assert "dc_blocker" in pipe.profile_report()

    # equivalence with the unprofiled (single-jit) step
    p2 = Pipeline(blk, block_size=nch * frames * 2, donate=False)
    s2 = cs.CollectSink()
    p2.run(iter([iq]), s2)
    want = s2.concat()
    assert np.max(np.abs(np.asarray(out) - np.asarray(want))) < 5e-4
