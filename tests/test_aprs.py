"""APRS / AFSK1200 receiver (models/aprs.py) and the shared HDLC layer."""

import numpy as np
import pytest

import csdr_tpu as cs
from csdr_tpu.models import aprs, hdlc

FS = 48000.0  # 40 samples/bit


def test_ax25_address_roundtrip():
    frame = aprs.make_ax25_ui("N0CALL-7", "APRS", ">Hello SDR radio!",
                              via=("WIDE1-1", "WIDE2-2"))
    msg = aprs.parse_ax25(frame)
    assert msg["src"] == "N0CALL-7" and msg["dst"] == "APRS"
    assert msg["via"] == ["WIDE1-1", "WIDE2-2"]
    assert msg["control"] == 0x03 and msg["pid"] == 0xF0
    assert msg["info"] == ">Hello SDR radio!"


def test_hdlc_layer_roundtrip_and_stuffing():
    # payload stressing the stuffer: runs of 1s (0xFF) around the CRC
    payload = bytes([0xFF, 0x7E, 0xFF, 0x00, 0xAA]) * 3
    levels = hdlc.frame_to_wire_bits(payload)
    frames = hdlc.hdlc_frames(levels)
    assert frames == [payload]
    # stuff/destuff inverse on random bits
    rng = np.random.default_rng(0)
    bits = "".join(rng.choice(["0", "1"], 500))
    assert hdlc.destuff(hdlc.stuff(bits)) == bits


def test_aprs_full_afsk_chain():
    """Two frames through the ACTUAL dual-tone discriminator chain with
    noise: AFSK modulate → afsk1200_receiver → host decode."""
    frames = [
        aprs.make_ax25_ui("N0CALL-7", "APRS", "!4903.50N/07201.75W-Test"),
        aprs.make_ax25_ui("K1ABC", "BEACON", ">status: all systems nominal",
                          via=("WIDE1-1",)),
    ]
    idle = np.ones(96, np.uint8)  # idle mark between bursts
    levels = np.concatenate(
        [idle] + sum(([aprs.aprs_burst_bits(f), idle] for f in frames), []))
    audio = aprs.afsk_modulate(levels, FS)
    rng = np.random.default_rng(1)
    audio = audio + 0.05 * rng.normal(size=len(audio)).astype(np.float32)

    snk = cs.CollectSink()
    cs.Pipeline(aprs.afsk1200_receiver(FS), block_size=1 << 15).run(
        iter([audio]), snk)
    msgs = aprs.decode_score(snk.concat(), FS)
    assert len(msgs) == 2, msgs
    assert msgs[0]["src"] == "N0CALL-7"
    assert msgs[0]["info"] == "!4903.50N/07201.75W-Test"
    assert msgs[1]["src"] == "K1ABC" and msgs[1]["via"] == ["WIDE1-1"]


def test_aprs_sharded_score_matches_serial():
    import jax
    from jax.sharding import Mesh

    from csdr_tpu.core.runtime import decode_tree_host
    from csdr_tpu.parallel import ShardedChain

    frame = aprs.make_ax25_ui("N0CALL", "APRS", "sharded")
    levels = np.concatenate([np.ones(96, np.uint8),
                             aprs.aprs_burst_bits(frame),
                             np.ones(96, np.uint8)])
    audio = aprs.afsk_modulate(levels, FS)
    block = 8192
    n = (len(audio) // block) * block
    serial = cs.CollectSink()
    pipe = cs.Pipeline(aprs.afsk1200_receiver(FS), block_size=block)
    pipe.run(iter([audio[:n]]), serial)

    mesh = Mesh(np.array(jax.devices()).reshape(8, 1), ("time", "ch"))
    sc = ShardedChain(aprs.afsk1200_receiver(FS), mesh, block)
    st = sc.init()
    outs = []
    for b in range(n // block):
        st, y = sc.step(st, audio[b * block:(b + 1) * block])
        outs.append(decode_tree_host(y))
    got = np.concatenate(outs)
    assert np.max(np.abs(got - serial.concat())) < 1e-6


def test_afsk_receiver_validates_rate():
    with pytest.raises(ValueError, match="1200"):
        aprs.afsk1200_receiver(44100.0)


def test_aprs_decode_cli_f32_and_cf32(tmp_path, monkeypatch, capsys):
    from csdr_tpu.apps.aprs_decode import main as aprs_main

    monkeypatch.chdir(tmp_path)
    frame = aprs.make_ax25_ui("N0CALL-9", "APRS", "!4903.50N/07201.75W-",
                              via=("WIDE2-1",))
    idle = np.ones(96, np.uint8)
    levels = np.concatenate([idle, aprs.aprs_burst_bits(frame), idle])
    audio = aprs.afsk_modulate(levels, FS)
    audio.tofile("aprs.f32")
    rc = aprs_main(["aprs.f32", "-s", str(FS), "-o", "frames.txt"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "N0CALL-9>APRS,WIDE2-1:!4903.50N/07201.75W-" in out
    assert open("frames.txt").read().startswith("N0CALL-9>APRS")

    # IQ input: FM-modulate the audio, decode via the built-in NBFM demod
    kf = 0.5
    iq = np.exp(1j * 2 * np.pi * kf * np.cumsum(audio * 0.5)).astype(np.complex64)
    iq.tofile("aprs.cf32")
    rc = aprs_main(["aprs.cf32", "-s", str(FS), "--kf", str(kf)])
    assert rc == 0
    assert "N0CALL-9>APRS" in capsys.readouterr().out


def test_cli_deais_and_deaprs(tmp_path, monkeypatch, capsys):
    """Packet flows as first-class --demod strings in the main CLI,
    serial and under --mesh."""
    from csdr_tpu.apps.soapy_sdr_cli import main as cli_main
    from csdr_tpu.models import ais

    monkeypatch.chdir(tmp_path)
    # AIS capture at 48 kHz
    k = int(FS // 9600)
    idle = np.array([0, 1] * 60, np.uint8)
    lv = np.concatenate([idle, ais.ais_burst_bits(
        ais.make_position_report(257123456, 59.9, 10.7, 5.0, 90.0)), idle])
    ais.ais_modulate(lv, k).astype(np.complex64).tofile("ais.cf32")
    n = len(lv) * k
    rc = cli_main(["--filename", "ais.cf32", "-s", str(FS), "-n", str(n),
                   "--demod", "DeAIS", "-o", "ships", "--blocksize", "16384"])
    assert rc == 0
    assert "mmsi 257123456" in capsys.readouterr().out
    assert "mmsi 257123456" in open("ships.ais.txt").read()

    # APRS: FM-modulated AFSK at 48 kHz, serial then --mesh
    frame = aprs.make_ax25_ui("N0CALL-1", "APRS", ">cli test")
    lv2 = np.concatenate([np.ones(96, np.uint8),
                          aprs.aprs_burst_bits(frame), np.ones(96, np.uint8)])
    audio = aprs.afsk_modulate(lv2, FS)
    kf = 0.5
    iq = np.exp(1j * 2 * np.pi * kf * np.cumsum(0.5 * audio)).astype(np.complex64)
    iq.tofile("aprs.cf32")
    for extra, out in ((["--mesh", "4x1"], "m"), ([], "s")):
        rc = cli_main(["--filename", "aprs.cf32", "-s", str(FS),
                       "-n", str(len(iq)), "--demod", f"DeAPRS {kf}",
                       "-o", out, "--blocksize", "19200"] + extra)
        assert rc == 0, extra
        assert "N0CALL-1>APRS:>cli test" in open(out + ".aprs.txt").read()
