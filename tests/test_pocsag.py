"""POCSAG pager receiver (models/pocsag.py): BCH(31,21) codec, batch/frame
bit layer and the full FSK chain, validated as an exact encoder/decoder
inverse pair — the paging sibling of test_ais.py / test_adsb.py."""

import numpy as np
import pytest

import csdr_tpu as cs
from csdr_tpu.models import pocsag as pg

FS = 38400.0  # k = 32 samples/bit at 1200 baud


def test_generator_self_test():
    # the spec's SYNC and IDLE words are themselves valid BCH codewords —
    # this pins the generator polynomial AND the bit ordering
    assert pg._valid(pg.SYNC) and pg._valid(pg.IDLE)
    assert pg.bch_encode((pg.SYNC >> 11) & 0x1FFFFF) == pg.SYNC
    assert pg.bch_encode((pg.IDLE >> 11) & 0x1FFFFF) == pg.IDLE


def test_bch_correction():
    cw = pg.bch_encode(0x15A3C7)
    assert pg.correct_codeword(cw) == cw
    for flips in ((3,), (0, 31), (7, 19)):
        bad = cw
        for b in flips:
            bad ^= 1 << b
        assert pg.correct_codeword(bad) == cw, flips
    assert pg.correct_codeword(cw ^ 0b10101) is None  # 3 errors: reject


def test_bit_layer_roundtrip_alpha_numeric_polarity():
    lv = pg.make_transmission(1234568, "HELLO SDR-1!")
    for stream in (lv, 1 - lv):  # both on-air polarities
        msgs = pg.decode_bits(stream)
        assert msgs == [{"ric": 1234568, "fn": 3, "kind": "alpha",
                         "text": "HELLO SDR-1!"}]
    msgs = pg.decode_bits(pg.make_transmission(99, "0123*U-()9"))
    assert msgs == [{"ric": 99, "fn": 0, "kind": "numeric",
                     "text": "0123*U-()9"}]


def test_bit_layer_error_correction_and_rejection():
    lv = pg.make_transmission(42, "PAGE ME")
    bad = lv.copy()
    bad[600] ^= 1
    bad[610] ^= 1  # two errors within one codeword: corrected
    assert pg.decode_bits(bad)[0]["text"] == "PAGE ME"


def test_two_transmissions_in_one_stream():
    # the 5000-bit gap (~4 s of idle at 1200 baud) regression-tests the
    # sync search advancing past empty windows instead of giving up
    gap = np.array([0, 1] * 2500, np.uint8)
    lv = np.concatenate([pg.make_transmission(8, "FIRST"), gap,
                         pg.make_transmission(2000001, "73 42", fn=0)])
    msgs = pg.decode_bits(lv)
    assert [m["ric"] for m in msgs] == [8, 2000001]
    assert msgs[0]["text"] == "FIRST" and msgs[1]["text"] == "73 42"


def _iq(lv, seed=1, noise=0.05):
    iq = pg.pocsag_modulate(lv, FS)
    rng = np.random.default_rng(seed)
    return (iq + noise * (rng.normal(size=len(iq))
                          + 1j * rng.normal(size=len(iq)))).astype(np.complex64)


def test_pocsag_full_fsk_chain():
    """Inverted-polarity FSK at 32 samples/bit through the ACTUAL device
    chain (FM discriminator → one-bit integrator), streamed in blocks."""
    lv = pg.make_transmission(1234568, "SDR PAGER OK")
    iq = _iq(lv)
    rx = cs.CollectSink()
    cs.Pipeline(pg.pocsag_receiver(FS), block_size=1 << 14).run(iter([iq]), rx)
    msgs = pg.decode_score(np.asarray(rx.concat()), FS)
    assert msgs == [{"ric": 1234568, "fn": 3, "kind": "alpha",
                     "text": "SDR PAGER OK"}]


def test_pocsag_receiver_validates_rate():
    with pytest.raises(ValueError, match="1200"):
        pg.pocsag_receiver(44100.0)


@pytest.mark.parametrize("dt", [2, 8])
def test_pocsag_chain_shards(dt):
    """FM-demod tail + FIR halo shard over time: score parity vs serial."""
    import jax
    from jax.sharding import Mesh
    from csdr_tpu.core.runtime import Pipeline, decode_tree_host
    from csdr_tpu.parallel.generic import ShardedChain

    if dt > len(jax.devices()):
        pytest.skip("not enough devices")
    mesh = Mesh(np.asarray(jax.devices()[:dt]).reshape(dt, 1), ("time", "ch"))
    iq = _iq(pg.make_transmission(77, "MESH"), seed=3)
    n = (len(iq) // (2 * dt)) * dt
    ref_pipe = Pipeline(pg.pocsag_receiver(FS), n, donate=False)
    sc = ShardedChain(pg.pocsag_receiver(FS), mesh, n)
    st = sc.init()
    for i in range(2):
        blk = iq[i * n:(i + 1) * n]
        ref = np.asarray(decode_tree_host(ref_pipe.process_block(blk)))
        st, y = sc.step(st, blk)
        got = np.asarray(decode_tree_host(y))
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_channelized_band_monitor():
    """A whole paging band in ONE device graph: PFB split into 8 channels,
    per channel a Tee of (pocsag score, envelope) via PerChannel vmap, host
    decode gated on channel power — three pages on three carriers decode
    with the right channel index and nothing else (the discriminator is
    amplitude-blind, so without the envelope gate the stopband leakage of a
    page would decode on neighboring channels too)."""
    nch, chan_rate = 8, 24000.0  # k = 20 samples/bit
    fs = nch * chan_rate
    pages = {1: (100001, "CH ONE"), 4: (200002, "CH FOUR"),
             6: (300003, "1234 5"), }
    streams = {}
    nlong = 0
    for ch, (ric, text) in pages.items():
        # channel-rate FSK baseband; the zero-order-hold upsample below
        # keeps its spectrum inside the channel, the PFB recovers it
        bb = pg.pocsag_modulate(pg.make_transmission(ric, text), chan_rate)
        streams[ch] = bb
        nlong = max(nlong, len(bb) * nch)
    t = np.arange(nlong)
    band = np.zeros(nlong, np.complex128)
    rng = np.random.default_rng(3)
    band += 0.01 * (rng.normal(size=nlong) + 1j * rng.normal(size=nlong))
    for ch, bb in streams.items():
        up = np.repeat(bb, nch)[:nlong]  # channel-rate baseband at fs
        fc = (ch - (nch - 1) / 2) / nch  # PFB channel center (ops/pfb.py)
        band += 0.5 * up * np.exp(2j * np.pi * np.mod(fc * t, 1.0))
    band = band.astype(np.complex64)

    graph = pg.pocsag_band_monitor(nch, chan_rate)
    rx = cs.CollectSink()
    cs.Pipeline(graph, block_size=graph.granule * 256).run(iter([band]), rx)
    msgs = pg.decode_channels(rx.concat(), chan_rate)
    got = {m["channel"]: (m["ric"], m["text"]) for m in msgs}
    assert got == pages, msgs
    # ungated (score-only) decode sees the leakage — the gate is load-bearing
    leaked = pg.decode_channels(np.asarray(rx.concat()[0]), chan_rate)
    assert len(leaked) > len(msgs)


@pytest.mark.parametrize("dt,dc", [(4, 1), (2, 4), (1, 8)])
def test_band_monitor_shards(dt, dc):
    """The band monitor (PFB → PerChannel(Tee(score, env))) under time- AND
    channel-sharded meshes matches single-device — the compositional
    sharding machinery covers the packet scale-out graph with no
    monitor-specific code."""
    import jax
    from jax.sharding import Mesh
    from csdr_tpu.core.runtime import Pipeline, decode_tree_host
    from csdr_tpu.parallel.generic import ShardedChain

    if dt * dc > len(jax.devices()):
        pytest.skip("not enough devices")
    nch, chan_rate = 8, 24000.0
    bb = pg.pocsag_modulate(pg.make_transmission(42, "MESH BAND"), chan_rate)
    n = len(bb) * nch
    t = np.arange(n)
    band = (0.5 * np.repeat(bb, nch)[:n]
            * np.exp(2j * np.pi * np.mod((2 - 3.5) / 8 * t, 1.0))
            ).astype(np.complex64)
    g = pg.pocsag_band_monitor(nch, chan_rate)
    mesh = Mesh(np.asarray(jax.devices()[:dt * dc]).reshape(dt, dc),
                ("time", "ch"))
    blk = (n // (dt * g.granule)) * dt * g.granule
    sc = ShardedChain(g, mesh, blk)
    st = sc.init()
    st, y = sc.step(st, band[:blk])
    want = decode_tree_host(Pipeline(g, blk, donate=False)
                            .process_block(band[:blk]))
    for a, b in zip(jax.tree.leaves(decode_tree_host(y)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=2e-5)


def test_cli_depocsag(tmp_path, monkeypatch, capsys):
    """DePOCSAG as a first-class --demod string, serial and under --mesh."""
    from csdr_tpu.apps.soapy_sdr_cli import main as cli_main

    monkeypatch.chdir(tmp_path)
    iq = _iq(pg.make_transmission(555, "CLI 99"), seed=5)
    iq.tofile("pocsag.cf32")
    for extra, out in (([], "s"), (["--mesh", "4x1"], "m")):
        rc = cli_main(["--filename", "pocsag.cf32", "-s", str(FS),
                       "-n", str(len(iq)), "--demod", "DePOCSAG 1200",
                       "-o", out, "--blocksize", str(1 << 14)] + extra)
        assert rc == 0, extra
        txt = open(out + ".pocsag.txt").read()
        assert "RIC 555" in txt and "CLI 99" in txt, (extra, txt)
    assert cli_main(["--filename", "pocsag.cf32", "-s", "44100",
                     "--demod", "DePOCSAG"]) == 1


def test_pocsag_decode_app(tmp_path, monkeypatch, capsys):
    from csdr_tpu.apps.pocsag_decode import main as pocsag_main

    monkeypatch.chdir(tmp_path)
    lv = pg.make_transmission(31337, "APP TEST")
    _iq(lv, seed=9).tofile("pg.cf32")
    rc = pocsag_main(["pg.cf32", "-s", str(FS), "-o", "pages.txt"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "RIC 31337" in out and "APP TEST" in out and "1 message(s)" in out
    assert "APP TEST" in open("pages.txt").read()

    # discriminator-audio input path (.f32): score sign = NON-inverted
    k = int(FS // 1200)
    disc = (2.0 * np.repeat(lv.astype(np.float32), k) - 1.0)
    disc.tofile("pg.f32")
    rc = pocsag_main(["pg.f32", "-s", str(FS)])
    assert rc == 0
    assert "APP TEST" in capsys.readouterr().out
    # wrong rate: clean error
    assert pocsag_main(["pg.cf32", "-s", "44100"]) == 1
