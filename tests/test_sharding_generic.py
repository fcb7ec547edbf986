"""Generic sharded execution (parallel/generic.ShardedChain) vs the
single-device Pipeline — the 'any composition shards' property.

The reference's Category instance makes any Pipe composition work
(/root/reference/src/ComposableSDR/Types.hs:93-103); these tests assert the
sharded analogue: arbitrary Block chains (FIR tails, distributed IIR/AGC/DC
recurrences, indexed NCO phase, channelizer fan-out with channel sharding,
Tee/Delay/Mix combinators) produce the same stream as single-device execution
on multiple mesh shapes, including streaming state continuity across blocks.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import csdr_tpu as cs
from csdr_tpu.core.runtime import Pipeline, decode_tree_host
from csdr_tpu.parallel.generic import ShardedChain
from csdr_tpu.parallel.runner import ShardedPipeline


def make_iq(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for f in (-0.29, -0.11, 0.07, 0.31):
        x += 0.35 * np.exp(2j * np.pi * np.mod(f * t, 1.0))
    return x.astype(np.complex64)


def mesh_of(dt, dc):
    if dt * dc > len(jax.devices()):
        pytest.skip("not enough devices")
    return Mesh(np.asarray(jax.devices()[:dt * dc]).reshape(dt, dc),
                ("time", "ch"))


def run_single(graph, iq, block, n_blocks):
    pipe = Pipeline(graph, block_size=block, donate=False)
    outs = []
    for b in range(n_blocks):
        y = decode_tree_host(pipe.process_block(iq[b * block:(b + 1) * block]))
        outs.append(y)
    return outs


def run_sharded(graph, iq, block, n_blocks, mesh):
    sh = ShardedChain(graph, mesh, block)
    state = sh.init()
    outs = []
    for b in range(n_blocks):
        state, y = sh.step(state, iq[b * block:(b + 1) * block])
        outs.append(decode_tree_host(y))
    return outs


def assert_close(got, want, tol=2e-3):
    for g, w in zip(got, want):
        gl, wl = jax.tree.leaves(g), jax.tree.leaves(w)
        assert len(gl) == len(wl)
        for ga, wa in zip(gl, wl):
            assert ga.shape == wa.shape, (ga.shape, wa.shape)
            scale = np.max(np.abs(wa)) + 1e-9
            err = np.max(np.abs(ga.astype(np.complex128) - wa.astype(np.complex128)))
            assert err / scale < tol, err / scale


# ---------------------------------------------------------------------------
# 1. WBFM receiver: resampler (halfband + rational) → dcBlocker → freqdem →
#    IIR de-emphasis → firdecim.  The VERDICT round-2 'done' graph #1.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt,dc", [(8, 1), (4, 2), (2, 4), (2, 1)])
def test_sharded_wbfm_receiver(dt, dc):
    mesh = mesh_of(dt, dc)
    graph = cs.chain(
        cs.resampler(0.4),          # halfband 2:1 + rational 4/5
        cs.dc_blocker(),
        cs.wbfm_demodulator(quad_rate=128_000.0, decim=4),
    )
    block = dt * graph.granule * max(1, 4096 // graph.granule)
    n_blocks = 3
    iq = make_iq(n_blocks * block)
    want = run_single(graph, iq, block, n_blocks)
    got = run_sharded(graph, iq, block, n_blocks, mesh)
    assert_close(got, want)


# ---------------------------------------------------------------------------
# 2. 20-channel split: dcBlocker → PFB(20).  VERDICT 'done' graph #2
#    (the reference's example-3 workload, README.md:184-195).
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt,dc", [(8, 1), (4, 2), (2, 4), (2, 2)])
def test_sharded_20ch_split(dt, dc):
    mesh = mesh_of(dt, dc)
    nch = 20
    graph = cs.chain(cs.dc_blocker(), cs.firpfbch_channelizer(nch))
    block = dt * nch * 128
    n_blocks = 3
    iq = make_iq(n_blocks * block)
    want = run_single(graph, iq, block, n_blocks)
    got = run_sharded(graph, iq, block, n_blocks, mesh)
    assert_close(got, want)


# ---------------------------------------------------------------------------
# 3. Channelize → per-channel (AGC + FM demod + audio decim): stacked
#    per-channel states sliced by the channel mesh axis, time collectives
#    batched under vmap.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt,dc", [(4, 2), (2, 4), (8, 1)])
def test_sharded_channelized_perchannel_agc(dt, dc):
    mesh = mesh_of(dt, dc)
    nch = 8
    per_ch = cs.chain(
        cs.automatic_gain_control(-40.0),
        cs.fm_demodulator(0.6),
        cs.fir_decimator(2),
    )
    graph = cs.chain(cs.dc_blocker(), cs.firpfbch_channelizer(nch),
                     cs.PerChannel(per_ch, nch))
    block = dt * nch * 2 * 128
    n_blocks = 3
    iq = make_iq(n_blocks * block)
    want = run_single(graph, iq, block, n_blocks)
    got = run_sharded(graph, iq, block, n_blocks, mesh)
    assert_close(got, want)


# ---------------------------------------------------------------------------
# 4. --mix flavor: channelize → per-channel demod → sum over channels
#    (psum over the ch axis re-enters the 1-D time-sharded layout).
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt,dc", [(4, 2), (8, 1)])
def test_sharded_mix_channels(dt, dc):
    mesh = mesh_of(dt, dc)
    nch = 4
    graph = cs.chain(
        cs.firpfbch_channelizer(nch),
        cs.PerChannel(cs.fm_demodulator(0.6), nch),
        cs.MixChannels(),
        cs.fir_decimator(2),
    )
    block = dt * nch * 2 * 128
    n_blocks = 2
    iq = make_iq(n_blocks * block)
    want = run_single(graph, iq, block, n_blocks)
    got = run_sharded(graph, iq, block, n_blocks, mesh)
    assert_close(got, want)


# ---------------------------------------------------------------------------
# 5. NCO mixers + complex IIR + AGC on the full-rate stream (indexed phase,
#    distributed complex poles, distributed log-gain recurrence).
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt,dc", [(8, 1), (4, 2), (4, 1)])
def test_sharded_mixer_iir_agc(dt, dc):
    mesh = mesh_of(dt, dc)
    graph = cs.chain(
        cs.mix_down(2.0 * np.pi * 0.123),
        cs.iir_cfilter(4, 0.2),
        cs.automatic_gain_control(-35.0),
        cs.mix_up(2.0 * np.pi * 0.05),
    )
    block = dt * 2048
    n_blocks = 3
    iq = make_iq(n_blocks * block)
    want = run_single(graph, iq, block, n_blocks)
    got = run_sharded(graph, iq, block, n_blocks, mesh)
    assert_close(got, want)


# ---------------------------------------------------------------------------
# 6. Tee + Delay combinators (tuple outputs, tuple out_specs).
# ---------------------------------------------------------------------------
def test_sharded_tee_delay():
    mesh = mesh_of(4, 1)
    b1 = cs.chain(cs.fir_filter_c_kaiser(33, 0.2), cs.fm_demodulator(0.6))
    b2 = cs.chain(cs.dc_blocker(), cs.am_demodulator())
    graph = cs.Tee(b1, b2)
    block = 4 * 1024
    n_blocks = 2
    iq = make_iq(n_blocks * block)
    want = run_single(graph, iq, block, n_blocks)
    got = run_sharded(graph, iq, block, n_blocks, mesh)
    assert_close(got, want)

    delay = cs.Delay(37, dtype=jnp.float32)
    blockf = 4 * 512
    xf = np.random.default_rng(3).normal(size=2 * blockf).astype(np.float32)
    want = run_single(delay, xf, blockf, 2)
    got = run_sharded(delay, xf, blockf, 2, mesh_of(4, 1))
    assert_close(got, want)


# ---------------------------------------------------------------------------
# 7. ShardedPipeline end-to-end: rechunk + pad/trim (exact sample accounting)
#    through the generic path, vs Pipeline.run.
# ---------------------------------------------------------------------------
def test_sharded_pipeline_end_to_end():
    mesh = mesh_of(4, 2)
    nch = 8
    graph = cs.chain(cs.dc_blocker(), cs.firpfbch_channelizer(nch),
                     cs.PerChannel(cs.fm_demodulator(0.6), nch))
    block = 4 * nch * 256
    n = block * 2 + block // 2  # non-multiple total: exercises pad+trim
    iq = make_iq(n + 4096)

    pipe = Pipeline(graph, block_size=block, donate=False)
    sink1 = cs.CollectSink()
    pipe.run(iter([iq]), sink1, num_samples=n)
    want = np.asarray(sink1.concat())

    sh = ShardedChain(graph, mesh, block)
    sp = ShardedPipeline(sh)
    sink2 = cs.CollectSink()
    total = sp.run(iter([iq]), sink2, num_samples=n)
    got = np.asarray(sink2.concat())

    assert got.shape == want.shape
    assert total == want.shape[-1]
    scale = np.max(np.abs(want)) + 1e-9
    assert np.max(np.abs(got - want)) / scale < 2e-3


# ---------------------------------------------------------------------------
# 8. Validation errors are raised statically.
# ---------------------------------------------------------------------------
def test_shard_validate_errors():
    mesh = mesh_of(4, 2)
    # halo longer than the local segment
    with pytest.raises(ValueError, match="halo"):
        ShardedChain(cs.fir_filter_c_kaiser(4097, 0.1), mesh, 4 * 1024)
    # channel axis does not divide nch
    with pytest.raises(ValueError, match="divisible"):
        ShardedChain(cs.chain(cs.firpfbch_channelizer(6)), mesh_of(2, 4), 2 * 6 * 256)
    # non-shardable block (sequential scan) refuses loudly.  (The block-mode
    # symsync itself shards since round-2 session 2 — the scan-mode feedback
    # loop is the remaining genuinely sequential case.)
    from csdr_tpu.models.symsync import sym_sync_r

    with pytest.raises(NotImplementedError):
        ShardedChain(sym_sync_r(2, 4, 0.5, 64, mode="scan"), mesh, 4 * 1024)


@pytest.mark.parametrize("dt", [2, 4, 8])
def test_sharded_stereo_fm_decoder(dt):
    """The full DeFMS graph — FM demod → stereo decoder (pilot NCO + three
    FIRs + group-delay line + distributed de-emphasis poles + decimators) —
    matches single-device on multiple time-mesh shapes."""
    from csdr_tpu.models.stereo import stereo_fm_decoder

    mesh = mesh_of(dt, 1)
    quad = 192000.0
    decim = 4
    n = 1 << 16
    t = np.arange(2 * n) / quad
    fL, fR = 800.0, 2500.0
    L = 0.8 * np.sin(2 * np.pi * fL * t)
    R = 0.8 * np.sin(2 * np.pi * fR * t)
    pilot = 0.1 * np.cos(2 * np.pi * 19000.0 * t + 0.7)
    sub = np.cos(2 * np.pi * 38000.0 * t + 1.4)
    mpx = (0.45 * (L + R) + pilot + 0.45 * (L - R) * sub).astype(np.float32)

    graph = cs.chain(stereo_fm_decoder(quad, decim))
    ref_pipe = Pipeline(graph, n)
    sc = ShardedChain(cs.chain(stereo_fm_decoder(quad, decim)), mesh, n)
    st = sc.init()
    for i in range(2):  # two global blocks: exercises carried state too
        blk = mpx[i * n:(i + 1) * n]
        ref = np.asarray(decode_tree_host(ref_pipe.process_block(blk)))
        st, y = sc.step(st, blk)
        got = np.asarray(decode_tree_host(y))
        assert got.shape == ref.shape == (2, n // decim)
        err = np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12)
        assert err < 2e-3, (dt, i, err)


def test_sharded_stereo_rejections():
    from csdr_tpu.models.stereo import stereo_fm_decoder

    mesh = mesh_of(2, 2)
    with pytest.raises(ValueError, match="time only"):
        ShardedChain(cs.chain(stereo_fm_decoder(192000.0, 4)), mesh, 1 << 16)
    mesh_t = mesh_of(4, 1)
    with pytest.raises(NotImplementedError, match="scan"):
        ShardedChain(cs.chain(stereo_fm_decoder(192000.0, 4, pll_mode="scan")),
                     mesh_t, 1 << 16)


@pytest.mark.parametrize("dt", [2, 8])
def test_sharded_gmsk_demod(dt):
    """GMSK demod (freqdem tail + matched-filter history) sharded over time:
    identical bit decisions to single-device, across two streamed blocks."""
    from csdr_tpu.blocks.gmsk import gmsk_demodulator, gmsk_mod

    mesh = mesh_of(dt, 1)
    k, m = 4, 3
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 4096)
    x = gmsk_mod(bits, k, m).astype(np.complex64)
    n = (len(x) // (2 * dt * k)) * dt * k  # two global blocks

    graph = cs.chain(gmsk_demodulator(m, k))
    ref_pipe = Pipeline(graph, n)
    sc = ShardedChain(cs.chain(gmsk_demodulator(m, k)), mesh, n)
    st = sc.init()
    for i in range(2):
        blk = x[i * n:(i + 1) * n]
        ref = np.asarray(decode_tree_host(ref_pipe.process_block(blk)))
        st, y = sc.step(st, blk)
        got = np.asarray(decode_tree_host(y))
        assert np.array_equal(got, ref), (dt, i, int(np.sum(got != ref)))


@pytest.mark.parametrize("dt", [2, 4, 8])
def test_sharded_symsync_fm_dem_with_sync(dt):
    """DeNBFMSync's graph — FM demod → block-parallel symbol sync — sharded:
    the timing-tone windows are summed per device and all-gathered, the
    global line fit is evaluated identically everywhere, and interpolation
    rides left+right halos.  Must match single-device almost exactly."""
    from csdr_tpu.models.symsync import fm_dem_with_sync

    mesh = mesh_of(dt, 1)
    k, nsym = 10, 16384
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, nsym)
    iq = np.exp(1j * np.cumsum(
        np.repeat((bits * 2 - 1) * 0.02 * k * 0.5, k) * 2 * np.pi)
    ).astype(np.complex64)
    n = (len(iq) // (2 * dt * k * 8)) * dt * k * 8  # two global blocks

    graph = cs.chain(fm_dem_with_sync(k))
    ref_pipe = Pipeline(graph, n)
    sc = ShardedChain(cs.chain(fm_dem_with_sync(k)), mesh, n)
    st = sc.init()
    for i in range(2):
        blk = iq[i * n:(i + 1) * n]
        ref = np.asarray(decode_tree_host(ref_pipe.process_block(blk)))
        st, y = sc.step(st, blk)
        got = np.asarray(decode_tree_host(y))
        assert got.shape == ref.shape
        err = np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12)
        assert err < 2e-3, (dt, i, err)


def test_sharded_symsync_rejects_tiny_blocks():
    from csdr_tpu.models.symsync import sym_sync_r

    mesh = mesh_of(8, 1)
    with pytest.raises(ValueError, match="sub-windows|halo|multiple"):
        ShardedChain(cs.chain(sym_sync_r(4, 4, 0.0, 64)), mesh, 8 * 4 * 8)


# ---------------------------------------------------------------------------
# Multi-rate Tee under a mesh (round 3): branches at different rational rates
# in ONE sharded graph — per-branch out_specs carry per-leaf local lengths.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt,dc", [(2, 1), (4, 1), (4, 2)])
def test_sharded_multirate_tee(dt, dc):
    from csdr_tpu.core.block import Tee

    mesh = mesh_of(dt, dc)
    graph = cs.chain(
        cs.dc_blocker(),
        Tee(cs.chain(cs.fir_filter_c_kaiser(33, 0.2), cs.fir_decimator(4)),
            cs.chain(cs.fir_filter_c_kaiser(17, 0.45))))
    block = dt * 4 * 512
    n_blocks = 3
    iq = make_iq(n_blocks * block)
    want = run_single(graph, iq, block, n_blocks)
    got = run_sharded(graph, iq, block, n_blocks, mesh)
    for g, w in zip(got, want):
        assert g[0].shape[0] * 4 == g[1].shape[0]  # 1/4-rate vs full-rate
    assert_close(got, want)


def test_sharded_multirate_tee_rejects_combining_block(dt=2):
    """A block that would combine a multi-rate tuple (different local
    lengths) refuses with a clear message."""
    from csdr_tpu.core.block import Tee, Lambda

    mesh = mesh_of(dt, 1)
    graph = cs.chain(
        Tee(cs.chain(cs.fir_decimator(4)), cs.chain(cs.fir_decimator(2))),
        Lambda(lambda xy: xy[0] + xy[1][::2], name="combine"))
    with pytest.raises(NotImplementedError, match="multi-rate"):
        ShardedChain(graph, mesh, dt * 8 * 512)


def test_sharded_multirate_tee_runner_trims_per_leaf(dt=2):
    """ShardedPipeline trims each Tee leaf by its own rational rate on a
    short final block (the byte-accounting invariant, per branch)."""
    from csdr_tpu.core.block import Tee

    mesh = mesh_of(dt, 1)
    graph = cs.chain(Tee(cs.chain(cs.fir_decimator(4)),
                         cs.chain(cs.fir_filter_c_kaiser(9, 0.3))))
    block = dt * 4 * 256
    sh = ShardedChain(graph, mesh, block)
    runner = ShardedPipeline(sh)
    n_total = block + block // 2  # final block is half-full
    iq = make_iq(n_total)
    outs = list(runner.stream(iter([iq])))
    n1 = sum(o[0].shape[0] for o in outs)
    n2 = sum(o[1].shape[0] for o in outs)
    assert n1 == n_total // 4
    assert n2 == n_total
