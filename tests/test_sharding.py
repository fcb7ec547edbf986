"""Multi-device sharded channelized receiver vs the single-device pipeline.

Runs on the 8-device virtual CPU mesh (conftest).  This is the test seam for
'multi-host logic without a real slice' (SURVEY.md §4).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import csdr_tpu as cs
from csdr_tpu.core.runtime import Pipeline
from csdr_tpu.models.receivers import channelized_fm_receiver
from csdr_tpu.parallel.channelized import ShardedChannelizedFM, make_mesh
from csdr_tpu.utils import testsig


def reference_output(iq, nch, audio_decim, n_blocks):
    graph = cs.chain(
        cs.dc_blocker(),
        cs.firpfbch_channelizer(nch),
        cs.PerChannel(
            cs.chain(cs.fm_demodulator(0.6), cs.fir_decimator(audio_decim))
            if audio_decim > 1 else cs.fm_demodulator(0.6),
            nch,
        ),
    )
    pipe = Pipeline(graph, block_size=len(iq) // n_blocks, donate=False)
    sink = cs.CollectSink()
    pipe.run(iter([iq]), sink)
    return np.asarray(sink.concat())


def make_input(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for f in (-0.31, -0.07, 0.11, 0.33):
        x += 0.4 * np.exp(2j * np.pi * np.mod(f * t, 1.0))
    return x.astype(np.complex64)


@pytest.mark.parametrize("mesh_shape,audio_decim", [((4, 2), 1), ((2, 4), 2), ((8, 1), 1), ((1, 2), 1)])
def test_sharded_matches_single_device(mesh_shape, audio_decim):
    dt, dc = mesh_shape
    ndev = dt * dc
    if ndev > len(jax.devices()):
        pytest.skip("not enough devices")
    nch = 8
    n_blocks = 2
    block = dt * nch * audio_decim * 256
    n = n_blocks * block
    iq = make_input(n)

    want = reference_output(iq, nch, audio_decim, n_blocks)

    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:ndev]).reshape(dt, dc), ("time", "ch"))
    sh = ShardedChannelizedFM(mesh=mesh, nch=nch, block_size=block,
                              audio_decim=audio_decim)
    state = sh.init()
    outs = []
    for b in range(n_blocks):
        xb = jax.device_put(jnp.asarray(iq[b * block:(b + 1) * block]), sh.input_sharding())
        state, y = sh.step(state, xb)
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=1)

    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    scale = np.max(np.abs(want)) + 1e-12
    assert err / scale < 2e-3, err / scale


def test_make_mesh():
    m = make_mesh(8)
    assert m.shape["time"] * m.shape["ch"] == 8
    # documented preference: never fewer time-shards than channel-shards
    assert m.shape["time"] >= m.shape["ch"]
    m4 = make_mesh(4)
    assert (m4.shape["time"], m4.shape["ch"]) == (2, 2)
    m2 = make_mesh(2)
    assert (m2.shape["time"], m2.shape["ch"]) == (2, 1)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 1)])
def test_sharded_agc_squelch_matches_single_device(mesh_shape):
    """Per-channel AGC+squelch across the mesh (distributed log-gain
    recurrence) vs the single-device graph."""
    dt, dc = mesh_shape
    ndev = dt * dc
    if ndev > len(jax.devices()):
        pytest.skip("not enough devices")
    nch = 8
    thr = -60.0
    n_blocks = 2
    block = dt * nch * 512
    n = n_blocks * block
    iq = make_input(n, seed=11) * 0.05

    graph = cs.chain(
        cs.dc_blocker(),
        cs.firpfbch_channelizer(nch),
        cs.PerChannel(cs.chain(cs.automatic_gain_control(thr),
                               cs.fm_demodulator(0.6)), nch),
    )
    pipe = Pipeline(graph, block_size=block, donate=False)
    sink = cs.CollectSink()
    pipe.run(iter([iq]), sink)
    want = np.asarray(sink.concat())

    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:ndev]).reshape(dt, dc), ("time", "ch"))
    sh = ShardedChannelizedFM(mesh=mesh, nch=nch, block_size=block,
                              agc_threshold_db=thr)
    state = sh.init()
    outs = []
    for b in range(n_blocks):
        xb = jax.device_put(jnp.asarray(iq[b * block:(b + 1) * block]),
                            sh.input_sharding())
        state, y = sh.step(state, xb)
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=1)

    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    scale = np.max(np.abs(want)) + 1e-12
    assert err / scale < 5e-3, err / scale


@pytest.mark.parametrize("wire", ["cf32", "cu8"])
@pytest.mark.parametrize("dt", [1, 2, 4, 8])
def test_channelized_sharded_vs_serial(dt, wire):
    """The 64-channel-style flow time-sharded over dt devices (the path
    `--mesh dtx1` takes) vs the serial Pipeline, on both wire formats: cu8
    bytes are converted on the device by u8_to_iq in the serial graph and by
    the CLI's front end before the sharded step."""
    if dt > len(jax.devices()):
        pytest.skip("not enough devices")
    from jax.sharding import Mesh
    from csdr_tpu.parallel.runner import ShardedPipeline
    from csdr_tpu.utils import reference as R

    nch, n_blocks = 16, 2
    block = dt * nch * 128
    iq, k_sig = testsig.fm_channel_capture(n_blocks * block, nch, seed=dt)
    graph = channelized_fm_receiver(nch, kf=0.6)
    if wire == "cu8":
        u8 = testsig.to_cu8(iq)
        serial = Pipeline(cs.chain(cs.u8_to_iq(), graph),
                          block_size=2 * block, donate=False)
        src_serial = u8
        iq = R.cu8_to_iq(u8).astype(np.complex64)
    else:
        serial = Pipeline(graph, block_size=block, donate=False)
        src_serial = iq
    sink = cs.CollectSink()
    serial.run(iter([src_serial]), sink)
    want = np.asarray(sink.concat())

    mesh = Mesh(np.asarray(jax.devices()[:dt]).reshape(dt, 1), ("time", "ch"))
    sh = ShardedChannelizedFM(mesh=mesh, nch=nch, block_size=block)
    msink = cs.CollectSink()
    ShardedPipeline(sh).run(iter([iq]), msink)
    got = np.asarray(msink.concat())

    assert got.shape == want.shape == (nch, n_blocks * block // nch)
    assert np.all(np.isfinite(got))
    # signal channels: against the serial run and the float64 reference
    # (noise-only channels wrap their discriminator phase at ±π, where a
    # last-bit difference moves a sample by a full cycle)
    from chip_smoke import SNR_FLOOR_DB
    ref = R.flagship_reference(iq, nch)
    assert np.min(R.channel_snr_db(want, got)[k_sig]) > SNR_FLOOR_DB
    assert np.min(R.channel_snr_db(ref, got)[k_sig]) > SNR_FLOOR_DB
