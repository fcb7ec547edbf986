"""Checkpoint/resume: bit-identical mid-stream continuation."""

import numpy as np
import pytest

import jax.numpy as jnp

import csdr_tpu as cs
from csdr_tpu.core.checkpoint import save_pipeline, resume_pipeline, save_state, load_state
from csdr_tpu.core.runtime import Pipeline
from csdr_tpu.utils import testsig


def graph():
    return cs.chain(cs.dc_blocker(), cs.mix_down(0.3), cs.fm_demodulator(0.6),
                    cs.fir_decimator(4))


def test_resume_is_bit_identical(tmp_path):
    n = 1 << 16
    rng = np.random.default_rng(0)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    bs = 1 << 14

    # uninterrupted run
    p0 = Pipeline(graph(), block_size=bs, donate=False)
    s0 = cs.CollectSink()
    p0.run(iter([x]), s0)
    want = np.asarray(s0.concat())

    # run half, checkpoint, resume in a fresh pipeline
    half = n // 2
    p1 = Pipeline(graph(), block_size=bs, donate=False)
    s1 = cs.CollectSink()
    p1.run(iter([x[:half]]), s1)
    ckpt = str(tmp_path / "ck.npz")
    save_pipeline(ckpt, p1, position=half)

    p2 = Pipeline(graph(), block_size=bs, donate=False)
    pos = resume_pipeline(ckpt, p2)
    assert pos == half
    s2 = cs.CollectSink()
    p2.run(iter([x[pos:]]), s2)

    got = np.concatenate([np.asarray(s1.concat()), np.asarray(s2.concat())])
    assert np.array_equal(got, want)


def test_signature_mismatch_rejected(tmp_path):
    p = Pipeline(graph(), block_size=1 << 12, donate=False)
    ck = str(tmp_path / "a.npz")
    save_pipeline(ck, p, position=0)
    other = Pipeline(cs.chain(cs.dc_blocker(), cs.am_demodulator()), block_size=1 << 12)
    try:
        resume_pipeline(ck, other)
        assert False, "should have raised"
    except ValueError:
        pass


def test_state_roundtrip_structure(tmp_path):
    blk = cs.firpfbch_channelizer(8)
    st = blk.init()
    path = str(tmp_path / "s.npz")
    save_state(path, st, position=123, signature="pfb")
    st2, pos = load_state(path, blk.init(), signature="pfb")
    assert pos == 123
    import jax
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(st2)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_periodic_checkpoint_during_run(tmp_path):
    """Pipeline.run(checkpoint_path=..., checkpoint_every=...) writes a
    resumable checkpoint mid-stream."""
    n = 1 << 15
    rng = np.random.default_rng(7)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    ck = str(tmp_path / "periodic.npz")
    p = Pipeline(graph(), block_size=1 << 13, donate=False)
    sink = cs.NullSink()
    p.run(iter([x]), sink, checkpoint_path=ck, checkpoint_every=1 << 14)
    import os
    assert os.path.exists(ck)
    p2 = Pipeline(graph(), block_size=1 << 13, donate=False)
    pos = resume_pipeline(ck, p2)
    assert pos >= 1 << 14


def test_checkpoint_path_without_npz_extension(tmp_path):
    """np.savez appends '.npz' to extension-less paths; save and resume with
    the SAME path string must agree (regression: resume raised
    FileNotFoundError for the natural 'job.ckpt' usage)."""
    import csdr_tpu as cs
    from csdr_tpu.core.checkpoint import resume_pipeline, save_pipeline

    pipe = cs.Pipeline(cs.dc_blocker(), block_size=1024)
    x = (np.random.default_rng(0).normal(size=1024)
         + 1j * np.random.default_rng(1).normal(size=1024)).astype(np.complex64)
    pipe.process_block(x)
    p = str(tmp_path / "job.ckpt")  # no .npz
    save_pipeline(p, pipe, position=1024)
    pipe2 = cs.Pipeline(cs.dc_blocker(), block_size=1024)
    pos = resume_pipeline(p, pipe2)
    assert pos == 1024


def test_checkpoint_position_never_exceeds_drained_output(tmp_path, monkeypatch):
    """Every periodic checkpoint must be written AFTER the block it covers
    reached the sink — otherwise a crash between save and the next drain
    loses one block of output on resume (position is past it, sink lacks
    it)."""
    import csdr_tpu as cs
    from csdr_tpu.core import checkpoint as ckpt_mod

    seen = []
    real_save = ckpt_mod.save_pipeline
    sink = cs.CollectSink()

    def spy_save(path, pipeline, position):
        drained = sum(len(a) for a in sink.parts)
        seen.append((position, drained))
        real_save(path, pipeline, position)

    monkeypatch.setattr(ckpt_mod, "save_pipeline", spy_save)
    n = 1 << 15
    x = (np.random.default_rng(2).normal(size=n)
         + 1j * np.random.default_rng(3).normal(size=n)).astype(np.complex64)
    pipe = cs.Pipeline(cs.dc_blocker(), block_size=4096)
    pipe.run(iter([x]), sink, checkpoint_path=str(tmp_path / "c.npz"),
             checkpoint_every=8192)
    assert seen, "no checkpoints were written"
    for position, drained in seen:
        assert drained >= position, (position, drained)  # rate 1: out == in


@pytest.mark.parametrize("wire", ["cf32", "cu8"])
@pytest.mark.parametrize("nch", [16, 64])
def test_flagship_resume_is_bit_identical(tmp_path, nch, wire):
    """Kill-and-resume of the flagship graph (dc_blocker → PFB → per-channel
    FM demod) mid-stream: the resumed output equals the uninterrupted one,
    on both wire formats."""
    from csdr_tpu.models.receivers import channelized_fm_receiver

    def flagship():
        g = channelized_fm_receiver(nch, kf=0.6)
        return cs.chain(cs.u8_to_iq(), g) if wire == "cu8" else g

    frames = 128
    bs = nch * frames * (2 if wire == "cu8" else 1)
    iq, _ = testsig.fm_channel_capture(4 * nch * frames, nch, seed=nch)
    x = testsig.to_cu8(iq) if wire == "cu8" else iq

    p0 = Pipeline(flagship(), block_size=bs, donate=False)
    s0 = cs.CollectSink()
    p0.run(iter([x]), s0)
    want = np.asarray(s0.concat())

    half = len(x) // 2
    p1 = Pipeline(flagship(), block_size=bs, donate=False)
    s1 = cs.CollectSink()
    p1.run(iter([x[:half]]), s1)
    ckpt = str(tmp_path / "flagship.npz")
    save_pipeline(ckpt, p1, position=half)

    p2 = Pipeline(flagship(), block_size=bs, donate=False)
    pos = resume_pipeline(ckpt, p2)
    assert pos == half
    s2 = cs.CollectSink()
    p2.run(iter([x[pos:]]), s2)
    got = np.concatenate([np.asarray(s1.concat()), np.asarray(s2.concat())],
                         axis=1)
    assert got.shape == want.shape == (nch, 4 * frames)
    assert np.array_equal(got, want)
