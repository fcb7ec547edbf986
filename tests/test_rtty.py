"""RTTY receiver (models/rtty.py): ITA2 codec, asynchronous char framing and
the full dual-tone chain, validated as an exact encoder/decoder inverse pair
— the HF teletype sibling of test_aprs.py."""

import numpy as np
import pytest
import scipy.signal as sig

import csdr_tpu as cs
from csdr_tpu.models import rtty

FS = 8000.0  # 176 samples/bit at 45.45 Bd (22 ms bits)
MSG = "CQ CQ DE SDR1 SDR1 599 73"


def test_ita2_codec_roundtrip_with_shifts():
    codes = rtty.ita2_encode(MSG)
    assert rtty.ita2_decode(codes) == MSG
    # digits force FIGS, letters force LTRS back — shifts present
    assert 27 in codes and 31 in codes
    with pytest.raises(ValueError, match="ITA2"):
        rtty.ita2_encode("~")


def test_rtty_full_chain():
    """Audio tones → the ACTUAL device chain (retuned AFSK discriminator),
    streamed in blocks → async framing → text."""
    audio = rtty.rtty_modulate(MSG, FS)
    rng = np.random.default_rng(1)
    audio = (audio + 0.1 * rng.normal(size=len(audio))).astype(np.float32)
    rx = cs.CollectSink()
    cs.Pipeline(rtty.rtty_receiver(FS), block_size=1 << 14).run(
        iter([audio]), rx)
    assert rtty.decode_score(np.asarray(rx.concat()), FS) == MSG


def test_rtty_receiver_validates_rate():
    with pytest.raises(ValueError, match="45.4"):
        rtty.rtty_receiver(44100.0)


@pytest.mark.parametrize("dt", [4])
def test_rtty_chain_shards(dt):
    import jax
    from jax.sharding import Mesh
    from csdr_tpu.core.runtime import Pipeline, decode_tree_host
    from csdr_tpu.parallel.generic import ShardedChain

    if dt > len(jax.devices()):
        pytest.skip("not enough devices")
    mesh = Mesh(np.asarray(jax.devices()[:dt]).reshape(dt, 1), ("time", "ch"))
    audio = rtty.rtty_modulate("MESH 1", FS)
    n = (len(audio) // (2 * dt)) * dt
    ref_pipe = Pipeline(rtty.rtty_receiver(FS), n, donate=False)
    sc = ShardedChain(rtty.rtty_receiver(FS), mesh, n)
    st = sc.init()
    for i in range(2):
        blk = audio[i * n:(i + 1) * n]
        ref = np.asarray(decode_tree_host(ref_pipe.process_block(blk)))
        st, y = sc.step(st, blk)
        np.testing.assert_allclose(np.asarray(decode_tree_host(y)), ref,
                                   rtol=0, atol=2e-5)


def test_cli_dertty(tmp_path, monkeypatch, capsys):
    """DeRTTY in the main CLI: USB IQ at 8 kHz → USB demod → discriminator
    → ITA2 text, serial and under --mesh."""
    from csdr_tpu.apps.soapy_sdr_cli import main as cli_main

    monkeypatch.chdir(tmp_path)
    audio = rtty.rtty_modulate("RYRY DE N0CLI", FS).astype(np.float64)
    iq = (0.5 * sig.hilbert(audio)).astype(np.complex64)
    iq.tofile("rtty.cf32")
    for extra, out in (([], "s"), (["--mesh", "4x1"], "m")):
        rc = cli_main(["--filename", "rtty.cf32", "-s", str(FS),
                       "-n", str(len(iq)), "--demod", "DeRTTY",
                       "-o", out, "--blocksize", str(1 << 14)] + extra)
        assert rc == 0, extra
        assert "RYRY DE N0CLI" in open(out + ".rtty.txt").read(), extra
    assert cli_main(["--filename", "rtty.cf32", "-s", "44100",
                     "--demod", "DeRTTY"]) == 1
