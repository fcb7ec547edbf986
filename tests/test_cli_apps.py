"""CLI (soapy-sdr equivalent), helidecode, GMSK demod."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

import csdr_tpu as cs
from csdr_tpu.apps.soapy_sdr_cli import main as cli_main, parse_demod
from csdr_tpu.apps import helidecode as hd
from csdr_tpu.blocks.gmsk import gmsk_demodulator, gmsk_mod
from csdr_tpu.io import wav as wavio
from csdr_tpu.utils import testsig


def test_parse_demod_strings():
    assert parse_demod("DeNo") == ("DeNo",)
    assert parse_demod("DeNBFM 0.6 WAV") == ("DeNBFM", 0.6, "WAV")
    assert parse_demod("DeWBFM 8 AU") == ("DeWBFM", 8, "AU")
    assert parse_demod("DeFMS 4 WAV") == ("DeFMS", 4, "WAV")
    assert parse_demod("DeNBFMSync 10") == ("DeNBFMSync", 10)
    assert parse_demod("DeAM WAV") == ("DeAM", "WAV")


def _write_fm_capture(path, n, fs=256000.0, kf=0.6, seed=0):
    from scipy.signal import firwin, lfilter
    rng = np.random.default_rng(seed)
    msg = lfilter(firwin(301, 2 * 3000.0 / fs), [1.0], rng.normal(size=n))
    msg = (msg / (3.0 * np.max(np.abs(msg)))).astype(np.float32)
    iq = testsig.fm_mod(msg, kf)
    iq.tofile(path)
    return msg


def test_cli_wbfm_mono(tmp_path):
    os.chdir(tmp_path)
    n = 1 << 17
    fs = 256000.0
    msg = _write_fm_capture("cap.cf32", n, fs)
    rc = cli_main([
        "--filename", "cap.cf32", "-s", str(fs), "-n", str(n),
        "--demod", "DeWBFM 8 WAV", "-o", "radio",
        "--blocksize", str(1 << 15),
    ])
    assert rc == 0
    audio, sr = wavio.read_wav("radio.wav")
    assert sr == int(fs) // 8
    assert len(audio) == n // 8
    # content check vs oracle (loose: de-emphasized audio correlates with msg)
    from csdr_tpu.utils.testsig import snr_db
    import scipy.signal as sig
    from csdr_tpu.utils.iirdes import butter_sos
    iq = np.fromfile("cap.cf32", dtype=np.complex64)
    dd = np.concatenate([[0.0], np.angle(iq[1:] * np.conj(iq[:-1])) / (2 * np.pi * 0.6)])
    de = sig.sosfilt(butter_sos(2, 5000.0 / fs), dd)
    from csdr_tpu.utils.firdes import firdecim_kaiser
    want = sig.lfilter(firdecim_kaiser(8, 10, 60.0), [1.0], de)[::8]
    assert snr_db(want[100:], audio[100:]) > 35.0


def test_cli_channel_split_sample_accounting(tmp_path):
    """The reference's headline invariant: N samples through a c-channel split
    produce exactly N/c samples per channel file (README.md:191-192)."""
    os.chdir(tmp_path)
    nch = 4
    n = 1 << 16
    rng = np.random.default_rng(1)
    iq = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    iq.tofile("wide.cf32")
    rc = cli_main([
        "--filename", "wide.cf32", "-n", str(n), "-c", str(nch),
        "-o", "split", "--blocksize", str(1 << 14),
    ])
    assert rc == 0
    for i in range(1, nch + 1):
        sz = os.path.getsize(f"split_ch{i}.cf32")
        assert sz == (n // nch) * 8, (i, sz)


def test_cli_channelize_demod_mix(tmp_path):
    os.chdir(tmp_path)
    nch = 4
    n = 1 << 16
    rng = np.random.default_rng(2)
    iq = (0.1 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    iq.tofile("wide.cf32")
    rc = cli_main([
        "--filename", "wide.cf32", "-n", str(n), "-c", str(nch), "-m",
        "--demod", "DeNBFM 0.6 WAV", "-o", "mixed",
        "--blocksize", str(1 << 14),
    ])
    assert rc == 0
    audio, sr = wavio.read_wav("mixed.wav")
    assert len(audio) == n // nch


def test_cli_am_with_agc(tmp_path):
    os.chdir(tmp_path)
    n = 1 << 15
    t = np.arange(n)
    msg = 0.5 * np.sin(2 * np.pi * 0.003 * t)
    iq = testsig.am_mod(msg.astype(np.float32), 0.8) * 0.05
    iq.astype(np.complex64).tofile("am.cf32")
    rc = cli_main([
        "--filename", "am.cf32", "-n", str(n),
        "--demod", "DeAM WAV", "-a", "-70", "-o", "am_out",
        "--blocksize", str(1 << 14),
    ])
    assert rc == 0
    audio, _ = wavio.read_wav("am_out.wav")
    assert len(audio) == n


def test_cli_au_output(tmp_path):
    os.chdir(tmp_path)
    n = 1 << 14
    t = np.arange(n)
    iq = testsig.am_mod((0.5 * np.sin(2 * np.pi * 0.01 * t)).astype(np.float32), 0.8)
    iq.astype(np.complex64).tofile("am.cf32")
    rc = cli_main(["--filename", "am.cf32", "-n", str(n), "--demod", "DeAM AU",
                   "-o", "am_au", "--blocksize", str(1 << 13)])
    assert rc == 0
    audio, sr = wavio.read_au("am_au.au")
    assert len(audio) == n


def test_cli_synthetic_device(tmp_path):
    os.chdir(tmp_path)
    rc = cli_main([
        "--devname", "synthetic", "-s", "2.56e6", "-n", str(1 << 16),
        "-o", "dev_cap", "--blocksize", str(1 << 14),
    ])
    assert rc == 0
    assert os.path.getsize("dev_cap.cf32") == (1 << 16) * 8


def test_cli_fms_stereo(tmp_path):
    os.chdir(tmp_path)
    # FM-modulated stereo MPX
    quad = 192000.0
    n = 1 << 16
    t = np.arange(n) / quad
    L = 0.6 * np.sin(2 * np.pi * 700.0 * t)
    R = 0.6 * np.sin(2 * np.pi * 2200.0 * t)
    pilot = 0.1 * np.cos(2 * np.pi * 19000.0 * t)
    mpx = 0.45 * (L + R) + pilot + 0.45 * (L - R) * np.cos(2 * np.pi * 38000.0 * t)
    iq = testsig.fm_mod((0.3 * mpx).astype(np.float32), 0.8)
    iq.tofile("fms.cf32")
    rc = cli_main([
        "--filename", "fms.cf32", "-s", str(quad), "-n", str(n),
        "--demod", "DeFMS 4 WAV", "-o", "stereo",
        "--blocksize", str(1 << 14),
    ])
    assert rc == 0
    audio, sr = wavio.read_wav("stereo.wav")
    # exact accounting WITH the end-of-stream flush (Block.flush_len): the
    # group-delay line's withheld samples are pushed out as extra frames
    from csdr_tpu.models.stereo import StereoFMDecoder

    nf = StereoFMDecoder(quad, 4).flush_len()
    assert nf > 0 and nf % 4 == 0
    assert audio.shape == ((n + nf) // 4, 2)
    # the WAV must be frame-interleaved (L R L R ...), not block-channel-
    # major: the dominant tone of column 0 is L's 700 Hz, column 1 R's
    # 2200 Hz.  (A raw channel-major write passes the shape check above but
    # scrambles both columns' spectra.)
    tail = audio[len(audio) // 2:]  # skip filter transients
    freqs = np.fft.rfftfreq(len(tail), d=4.0 / quad)
    for col, f_want in ((0, 700.0), (1, 2200.0)):
        spec = np.abs(np.fft.rfft(tail[:, col] * np.hanning(len(tail))))
        assert abs(freqs[np.argmax(spec)] - f_want) < 30.0, (col, f_want)


def test_cli_cu8_capture(tmp_path):
    """rtl_sdr-native .cu8 input: same results as the CF32 path within
    quantization noise."""
    os.chdir(tmp_path)
    n = 1 << 16
    rng = np.random.default_rng(7)
    iq = (0.4 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    iq = np.clip(iq.real, -1, 1) + 1j * np.clip(iq.imag, -1, 1)
    u8 = np.empty(2 * n, np.uint8)
    u8[0::2] = np.round(iq.real * 127.5 + 127.5).astype(np.uint8)
    u8[1::2] = np.round(iq.imag * 127.5 + 127.5).astype(np.uint8)
    u8.tofile("cap.cu8")
    rc = cli_main(["--filename", "cap.cu8", "-n", str(n), "-o", "from_u8",
                   "--blocksize", str(1 << 15)])
    assert rc == 0
    got = np.fromfile("from_u8.cf32", dtype=np.complex64)
    assert len(got) == n
    # compare against the CF32 path on the quantized signal
    q = ((np.round(iq.real * 127.5 + 127.5) - 127.5) / 127.5
         + 1j * (np.round(iq.imag * 127.5 + 127.5) - 127.5) / 127.5).astype(np.complex64)
    q.tofile("cap.cf32")
    rc = cli_main(["--filename", "cap.cf32", "-n", str(n), "-o", "from_f32",
                   "--blocksize", str(1 << 15)])
    assert rc == 0
    want = np.fromfile("from_f32.cf32", dtype=np.complex64)
    assert np.max(np.abs(got - want)) < 1e-5


def test_cli_mesh_flagship_production_kernel(tmp_path):
    """--mesh Nx1 on the plain channelized-FM flow (no AGC, nch | 64) runs
    the hand-sharded receiver (parallel/channelized.ShardedChannelizedFM),
    the same path as TxC — outputs must match the single-device CLI run."""
    import jax
    if len(jax.devices()) < 4:
        import pytest
        pytest.skip("needs 4 devices")
    os.chdir(tmp_path)
    nch = 8
    n = 1 << 17
    rng = np.random.default_rng(23)
    iq = (0.2 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    iq.tofile("wf.cf32")
    rc = cli_main(["--filename", "wf.cf32", "-n", str(n), "-c", str(nch),
                   "--demod", "DeNBFM 0.6 WAV", "-o", "fsingle",
                   "--blocksize", str(1 << 15)])
    assert rc == 0
    rc = cli_main(["--filename", "wf.cf32", "-n", str(n), "-c", str(nch),
                   "--demod", "DeNBFM 0.6 WAV", "-o", "fmeshed",
                   "--mesh", "4x1", "--blocksize", str(1 << 15)])
    assert rc == 0
    for chn in (1, nch // 2, nch):
        a, _ = wavio.read_wav(f"fsingle_ch{chn}.wav")
        b, _ = wavio.read_wav(f"fmeshed_ch{chn}.wav")
        assert len(a) == len(b) == n // nch
        assert np.max(np.abs(a[1:] - b[1:])) < 2e-3, chn


def test_cli_mesh_channelized(tmp_path):
    """--mesh 4x2 runs the sharded multi-device path; outputs must match the
    single-device CLI run."""
    import jax
    if len(jax.devices()) < 8:
        import pytest
        pytest.skip("needs 8 devices")
    os.chdir(tmp_path)
    nch = 8
    n = 1 << 17
    rng = np.random.default_rng(21)
    iq = (0.2 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    iq.tofile("w.cf32")
    rc = cli_main(["--filename", "w.cf32", "-n", str(n), "-c", str(nch),
                   "--demod", "DeNBFM 0.6 WAV", "-o", "single",
                   "--blocksize", str(1 << 15)])
    assert rc == 0
    rc = cli_main(["--filename", "w.cf32", "-n", str(n), "-c", str(nch),
                   "--demod", "DeNBFM 0.6 WAV", "-o", "meshed",
                   "--mesh", "4x2", "--blocksize", str(1 << 15)])
    assert rc == 0
    for chn in (1, nch // 2, nch):
        a, _ = wavio.read_wav(f"single_ch{chn}.wav")
        b, _ = wavio.read_wav(f"meshed_ch{chn}.wav")
        assert len(a) == len(b) == n // nch
        assert np.max(np.abs(a[1:] - b[1:])) < 2e-3, chn


def test_helidecode_roundtrip(tmp_path):
    os.chdir(tmp_path)
    # build frames: "AN 52 3045\r\nBW 21 0030\r\n" repeated to 69 chars + 2 pad
    text = "AN 52 3045\r\nBW 21 0030\r\n"
    payload = (b"\xff\xff" + (text * 3).encode("latin1"))[:71]
    # pad bits "11" like the real air protocol (all-zero pads would collide
    # with the sync pattern's zero runs; the reference's 10-bit chars carry
    # non-zero stuffing there too)
    frame_bits = "".join(
        "".join("1" if (b >> j) & 1 else "0" for j in range(8)) + "11"
        for b in payload
    )
    assert len(frame_bits) == 710
    sync = "1100000000" + "0100000000"
    bits = (sync + frame_bits) * 5 + sync
    # samples: 2 samples/bit; '0' → +1, '1' → -1 (sign slicing inverted)
    vals = np.repeat([1.0 if c == "0" else -1.0 for c in bits], 2).astype("<f4")
    vals.tofile("sync.f32")
    coords = hd.decode_file("sync.f32", "out.kml", "out.m")
    # 5 frames × 2 coords, clean() drops the first → 9
    assert len(coords) >= 9
    c = coords[0]
    assert abs(c.lat() - (52 + 30 / 60.0 + (45 / 100.0 * 60.0) / 3600.0)) < 1e-6
    assert os.path.exists("out.kml") and os.path.exists("out.m")
    kml = open("out.kml").read()
    assert "<coordinates>" in kml and "Helo" in kml


def test_gmsk_roundtrip():
    rng = np.random.default_rng(5)
    k, m = 8, 3
    nbits = 2048
    bits = rng.integers(0, 2, nbits)
    iq = gmsk_mod(bits, k, m, 0.3)
    blk = gmsk_demodulator(m, k, 0.3)
    st = blk.init()
    outs = []
    half = nbits * k // 2
    for i in range(2):
        st, y = blk.apply(st, jnp.asarray(iq[i * half:(i + 1) * half]))
        outs.append(np.asarray(y))
    got = np.concatenate(outs)
    # constant symbol delay from the matched filter: find best alignment
    best = 0
    for lag in range(0, 8):
        a = bits[:nbits - lag - 8]
        b = got[lag:lag + len(a)]
        best = max(best, np.mean(a == b))
    assert best > 0.995, best


def test_full_helicopter_chain(tmp_path):
    """The complete reference workflow end-to-end: 2-FSK IQ capture →
    soapy-sdr DeNBFMSync (NBFM demod + symbol sync, 2 samp/sym f32) →
    helidecode (frame sync, 10-bit chars, coordinate parse, KML)."""
    os.chdir(tmp_path)
    k = 10
    text = "AN 52 3045\r\nBW 21 0030\r\n"
    payload = (b"\xff\xff" + (text * 3).encode())[:71]
    frame = "".join("".join("1" if (b >> j) & 1 else "0" for j in range(8)) + "11"
                    for b in payload)
    sync = "1100000000" + "0100000000"
    bits = (sync + frame) * 10 + sync
    sym = np.array([+1.0 if c == "0" else -1.0 for c in bits])
    iq = np.exp(1j * 2 * np.pi * np.cumsum(
        np.repeat(sym * 0.02 * k * 0.5, k))).astype(np.complex64)
    iq.tofile("fsk.cf32")
    rc = cli_main(["--filename", "fsk.cf32", "-n", str(len(iq)),
                   "--demod", f"DeNBFMSync {k}", "-o", "sync_out",
                   "--blocksize", str(1 << 15)])
    assert rc == 0
    from csdr_tpu.apps import helidecode as hd2
    coords = hd2.decode_file("sync_out.f32", "out.kml", "out.m")
    assert len(coords) >= 10
    c = coords[0]
    assert abs(c.lat() - (52 + 30 / 60 + (45 / 100 * 60) / 3600)) < 1e-6
    assert abs(c.lon() - (21 + 0 / 60 + (30 / 100 * 60) / 3600)) < 1e-6
    assert "<coordinates>" in open("out.kml").read()


def test_cli_mesh_generic_wbfm_and_mix(tmp_path):
    """--mesh on non-flagship flows rides the generic compositional sharded
    runtime (ShardedChain): DeWBFM single-channel, and DeNBFM --mix."""
    import jax
    if len(jax.devices()) < 8:
        import pytest
        pytest.skip("needs 8 devices")
    os.chdir(tmp_path)
    n = 1 << 17
    rng = np.random.default_rng(22)
    t = np.arange(n)
    msg = 0.3 * np.sin(2 * np.pi * 0.001 * t)
    iq = (0.9 * np.exp(1j * 2 * np.pi * 0.6 * np.cumsum(msg))).astype(np.complex64)
    iq.tofile("w2.cf32")

    # DeWBFM, 1 channel: dc_blocker >> wbfm chain sharded over 'time'
    for tag, mesh in (("s", None), ("m", "4x2")):
        args = ["--filename", "w2.cf32", "-n", str(n), "-s", "512000",
                "--demod", "DeWBFM 4 WAV", "-o", f"wb_{tag}",
                "--blocksize", str(1 << 15)]
        if mesh:
            args += ["--mesh", mesh]
        assert cli_main(args) == 0
    a, _ = wavio.read_wav("wb_s.wav")
    b, _ = wavio.read_wav("wb_m.wav")
    assert len(a) == len(b) == n // 4
    assert np.max(np.abs(a - b)) < 2e-3

    # DeNBFM -c 4 --mix: channelizer + per-channel demod + psum mix.
    # Every channel needs a real carrier: demod of an EMPTY channel is
    # angle(numerical noise), which is not reproducible across reductions.
    tones = sum(0.5 * np.exp(2j * np.pi * np.mod(f * t, 1.0))
                for f in (-0.3, -0.05, 0.15, 0.4))
    (tones.astype(np.complex64)).tofile("w4.cf32")
    for tag, mesh in (("s", None), ("m", "2x4")):
        args = ["--filename", "w4.cf32", "-n", str(n), "-c", "4", "--mix",
                "--demod", "DeNBFM 0.6 WAV", "-o", f"mx_{tag}",
                "--blocksize", str(1 << 15)]
        if mesh:
            args += ["--mesh", mesh]
        assert cli_main(args) == 0
    a, _ = wavio.read_wav("mx_s.wav")
    b, _ = wavio.read_wav("mx_m.wav")
    assert len(a) == len(b) == n // 4
    scale = np.max(np.abs(a)) + 1e-9
    assert np.max(np.abs(a - b)) / scale < 2e-3


def test_cli_mesh_symsync_flow_and_bad_mesh(tmp_path):
    """DeNBFMSync shards since round-2 session 2 (the block-parallel symsync
    gained shard_apply) — the CLI runs it over a mesh with exact accounting;
    an oversized mesh still refuses cleanly (rc 1, no traceback)."""
    import jax
    if len(jax.devices()) < 4:
        import pytest
        pytest.skip("needs 4 devices")
    os.chdir(tmp_path)
    n = 1 << 16
    np.exp(1j * np.linspace(0, 500.0, n)).astype(np.complex64).tofile("z.cf32")
    rc = cli_main(["--filename", "z.cf32", "-n", str(n),
                   "--demod", "DeNBFMSync 10", "-o", "seq",
                   "--mesh", "4x1", "--blocksize", str(1 << 15)])
    assert rc == 0
    assert os.path.getsize("seq.f32") == (n * 2 // 10) * 4  # 2 samp/sym f32
    rc = cli_main(["--filename", "z.cf32", "-n", str(n),
                   "--demod", "DeNBFMSync 10", "-o", "seq2",
                   "--mesh", "64x1", "--blocksize", str(1 << 15)])
    assert rc == 1  # more devices than exist: clean refusal, not a traceback


def test_cli_play_tees_live_audio(tmp_path):
    """--play tees the demodulated audio into a player's stdin as float32le
    PCM; the stream must be byte-identical to the WAV payload (the built-in
    version of the reference's mkfifo playback workaround, README.md:160-165
    / the "live playback via PulseAudio" TODO, README.md:302)."""
    os.chdir(tmp_path)
    n = 1 << 16
    fs = 256000.0
    _write_fm_capture("cap.cf32", n, fs)
    rc = cli_main([
        "--filename", "cap.cf32", "-s", str(fs), "-n", str(n),
        "--demod", "DeWBFM 8 WAV", "-o", "radio",
        "--blocksize", str(1 << 14),
        "--play", "sh -c 'cat > play.bin'",
    ])
    assert rc == 0
    audio, sr = wavio.read_wav("radio.wav")
    played = np.fromfile("play.bin", dtype=np.float32)
    assert np.array_equal(played, audio)


def test_cli_play_ignored_without_audio(tmp_path, capsys):
    os.chdir(tmp_path)
    n = 1 << 14
    rng = np.random.default_rng(2)
    (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)\
        .tofile("wide.cf32")
    rc = cli_main([
        "--filename", "wide.cf32", "-n", str(n), "-o", "raw",
        "--play", "sh -c 'cat > should_not_exist.bin'",
    ])
    assert rc == 0
    assert "--play ignored" in capsys.readouterr().out
    assert not os.path.exists("should_not_exist.bin")


def test_cli_spectrum_and_constellation_taps(tmp_path):
    """--spectrum/--constellation tap the tuned IQ into Octave plot scripts
    while the demod flow runs unchanged (the reference's inspectrum/baudline
    workflow, README.md:126-146, as flags)."""
    os.chdir(tmp_path)
    n = 1 << 16
    fs = 256000.0
    _write_fm_capture("cap.cf32", n, fs)
    rc = cli_main([
        "--filename", "cap.cf32", "-s", str(fs), "-n", str(n),
        "--demod", "DeWBFM 8 WAV", "-o", "radio",
        "--blocksize", str(1 << 14),
        "--spectrum", "--constellation",
    ])
    assert rc == 0
    audio, sr = wavio.read_wav("radio.wav")
    assert len(audio) == n // 8  # main flow unaffected
    spec = open("radio_spectrum.m").read()
    assert "p = [" in spec and "print -dpng" in spec
    con = open("radio_constellation.m").read()
    assert "v(end+1)" in con


def test_helidecode_parse_anchored_and_clean_keeps_earlier():
    """parse_coords parses only the LEADING run of records (reference
    `many parseCoord` anchored at 0, HeliDecode.hs:66-67) and clean_coords
    keeps the EARLIER coord of each close pair (HeliDecode.hs:126-129)."""
    rec = "AN 50 0732\r\nBW 20 0515\r\n"
    # leading garbage -> no coords; trailing garbage stops the run
    assert hd.parse_coords("X" + rec) == []
    assert len(hd.parse_coords(rec + "junk" + rec)) == 1
    assert len(hd.parse_coords(rec + rec)) == 2

    a = hd.Coord(50.0, 7.0, 0.0, 20.0, 5.0, 0.0)
    b = hd.Coord(50.0, 7.0, 1.0, 20.0, 5.0, 0.0)   # ~30 m from a
    far = hd.Coord(51.0, 7.0, 0.0, 20.0, 5.0, 0.0)  # ~111 km away
    assert hd.clean_coords([a, b, far]) == [a]      # keeps predecessor only


def test_helidecode_bits_vectorized_matches_sign_slicing():
    rng = np.random.default_rng(0)
    s = rng.normal(size=4096).astype(np.float32)
    bits = hd.bits_from_samples(s)
    want = "".join("0" if v > 0 else "1" for v in s[0::2])
    assert bits == want


def test_cli_verbose_prints_block_configs(tmp_path, capsys):
    """-v prints every block's config as the flow is assembled (the
    reference's liquid *_print behavior, SURVEY §5) + a throughput line."""
    os.chdir(tmp_path)
    n = 1 << 15
    fs = 256000.0
    _write_fm_capture("cap.cf32", n, fs)
    rc = cli_main([
        "--filename", "cap.cf32", "-s", str(fs), "-n", str(n), "-v",
        "--demod", "DeWBFM 8 WAV", "-o", "radio", "-b", "128000",
        "--blocksize", str(1 << 14),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Front end (rate" in out       # resampler front end announced
    assert "Flow (rate 1/8" in out
    assert "fm_demod(0.6)" in out and "dc_blocker" in out
    assert "Throughput:" in out and "MSPS out" in out
