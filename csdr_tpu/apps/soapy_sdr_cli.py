"""soapy-sdr — the reference CLI re-implemented on the JAX runtime.

Drop-in flag surface of /root/reference/apps/SoapySDR.hs:60-143, including the
Haskell-`Read`-style --demod strings:

    --demod "DeNBFM 0.6 WAV" | "DeWBFM 8 WAV" | "DeFMS 8 WAV"
            | "DeNBFMSync 10" | "DeAM AU" | "DeNo"

Flow assembly mirrors sdrProcess/assembleFold (apps/SoapySDR.hs:181-283):
source → offset mixer → resampler → takeN → dcBlocker →
{demod | channelizer → per-channel (agc→demod) → per-channel sinks | mix}.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .. import blocks as B
from ..core.block import MixChannels, PerChannel, chain
from ..core.runtime import Pipeline
from ..io import sinks as S
from ..io import sources as SRC

__all__ = ["main", "build_parser", "run_opts"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="soapy-sdr",
        description="Process samples from an SDR (or IQ/WAV file) on an accelerator",
    )
    p.add_argument("--filename", metavar="NAME", help="Input (CF32) file name")
    p.add_argument("--chunksize", type=int, default=1024, metavar="INT",
                   help="Chunk size in CF32 samples")
    p.add_argument("--devname", default="rtlsdr", metavar="NAME",
                   help="Soapy device/driver name")
    p.add_argument("--ppm", type=int, default=0, metavar="INT",
                   help="Frequency correction in ppm (rtl_tcp driver)")
    p.add_argument("--bias-t", dest="bias_t", action="store_true",
                   help="Power the bias tee (rtl_tcp driver)")
    p.add_argument("-f", "--frequency", type=float, default=100.0e6, metavar="DOUBLE",
                   help="Rx frequency in Hz")
    p.add_argument("-g", "--gain", type=float, default=0.0, metavar="DOUBLE",
                   help="SDR gain level (0 = auto)")
    p.add_argument("-s", "--samplerate", type=float, default=2.56e6, metavar="DOUBLE",
                   help="Sample rate in Hz")
    p.add_argument("--offset", type=float, default=0.0, metavar="DOUBLE",
                   help="Offset frequency in Hz")
    p.add_argument("-b", "--bandwidth", type=float, default=0.0, metavar="DOUBLE",
                   help="Desired output bandwidth in Hz (0 = samplerate = no resampling)")
    p.add_argument("-n", "--numsamples", type=int, default=1024, metavar="INT",
                   help="Number of samples to capture")
    p.add_argument("-o", "--output", default="output", metavar="FILENAME",
                   help="Output file(s) name (without extension)")
    p.add_argument("--demod", default="DeNo", metavar="DEMOD",
                   help='Demodulation type, e.g. "DeNBFM 0.6 WAV" (also '
                        'DeWBFM/DeFMS/DeAM/DeNBFMSync like the reference, '
                        'plus extensions "DeUSB 3000 WAV" / "DeLSB 3000 WAV" '
                        '/ "DeCW [bw pitch] WAV" / "DeAIS" / "DeAPRS [kf]" / '
                        '"DeADSB" / "DePOCSAG [baud]" / "DeRTTY [baud]")')
    p.add_argument("--rds", action="store_true",
                   help="With --demod 'DeFMS ...': also decode the 57 kHz RDS "
                        "subcarrier (PS/RadioText/PI) to <output>.rds.txt "
                        "(capability extension; one pipeline — the composite "
                        "feeds a multi-rate Tee, stereo + bit branches)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Print each block's configuration as the flow is "
                        "assembled (the reference prints every liquid "
                        "object's config, SURVEY §5) and a throughput "
                        "summary at the end")
    p.add_argument("--spectrum", nargs="?", const="", default=None,
                   metavar="FILE",
                   help="Also write a Welch-averaged PSD Octave script of "
                        "the tuned IQ (default <output>_spectrum.m) — the "
                        "reference's inspectrum workflow as a flag")
    p.add_argument("--constellation", nargs="?", const="", default=None,
                   metavar="FILE",
                   help="Also write a constellation scatter Octave script "
                        "of the tuned IQ (default <output>_constellation.m)")
    p.add_argument("--play", nargs="?", const="", default=None, metavar="CMD",
                   help="Also play demodulated audio live (pacat/aplay/play "
                        "autodetected, or give a command; float32le PCM on "
                        "its stdin) — the reference's PulseAudio TODO")
    p.add_argument("-a", "--agc", type=float, default=0.0, metavar="DOUBLE",
                   help="Enable AGC with squelch threshold in dB (0 = no AGC)")
    p.add_argument("-c", "--channels", type=int, default=1, metavar="INT",
                   help="Number of channels to split the signal into")
    p.add_argument("-m", "--mix", action="store_true",
                   help="Mix the channels into one output instead of per-channel files")
    p.add_argument("--blocksize", type=int, default=1 << 20,
                   help="Device block size in samples (not in the reference)")
    p.add_argument("--profile", action="store_true",
                   help="Per-block profiling: run each stage as its own "
                        "device step and print a time-budget table "
                        "(MSPS per stage) at the end of the run")
    p.add_argument("--mesh", default=None, metavar="TxC",
                   help="Run the flow on a device mesh, e.g. '4x2' = 4 "
                        "time-shards x 2 channel-shards.  Every demod flow "
                        "shards (channelized FM uses the hand-sharded "
                        "receiver); "
                        "per-sample scan modes refuse with a clear message")
    return p


def parse_demod(s: str):
    """Parse the reference's Haskell-Read Demod syntax
    (apps/SoapySDR.hs:19-29)."""
    toks = s.replace("(", " ").replace(")", " ").split()
    if not toks:
        return ("DeNo",)
    kind = toks[0]
    if kind == "DeNo":
        return ("DeNo",)
    if kind == "DeNBFM":
        return ("DeNBFM", float(toks[1]), toks[2].upper())
    if kind == "DeWBFM":
        return ("DeWBFM", int(toks[1]), toks[2].upper())
    if kind == "DeFMS":
        return ("DeFMS", int(toks[1]), toks[2].upper())
    if kind == "DeNBFMSync":
        return ("DeNBFMSync", int(toks[1]))
    if kind == "DeAM":
        return ("DeAM", toks[1].upper())
    if kind in ("DeUSB", "DeLSB"):
        # capability extensions beyond the reference's Demod ADT:
        # "DeUSB 3000 WAV" — single-sideband, audio bandwidth in Hz
        return (kind, float(toks[1]), toks[2].upper())
    if kind == "DeCW":
        # "DeCW WAV" or "DeCW <bw Hz> <pitch Hz> WAV"
        if len(toks) == 2:
            return ("DeCW", 500.0, 700.0, toks[1].upper())
        return ("DeCW", float(toks[1]), float(toks[2]), toks[3].upper())
    if kind == "DeAIS":
        # GMSK 9600-baud AIS → <output>.ais.txt (extension)
        return ("DeAIS",)
    if kind == "DeAPRS":
        # "DeAPRS [kf]": NBFM → AFSK1200 → <output>.aprs.txt (extension)
        return ("DeAPRS", float(toks[1]) if len(toks) > 1 else 0.5)
    if kind == "DeADSB":
        # Mode S PPM at 2n MS/s → <output>.adsb.txt (extension)
        return ("DeADSB",)
    if kind == "DePOCSAG":
        # "DePOCSAG [baud]": FSK pager decode → <output>.pocsag.txt (extension)
        return ("DePOCSAG", float(toks[1]) if len(toks) > 1 else 1200.0)
    if kind == "DeRTTY":
        # "DeRTTY [baud]": USB → ITA2 teletype → <output>.rtty.txt (extension)
        return ("DeRTTY", float(toks[1]) if len(toks) > 1 else 1000.0 / 22.0)
    raise ValueError(f"unknown demod {s!r}")


def _open_source(opts):
    """Source selection with device-enumeration fallback
    (apps/SoapySDR.hs:155-179)."""
    if opts.filename:
        if opts.filename.endswith(".cu8"):
            # rtl_sdr native interleaved uint8 IQ (capability extension)
            return SRC.cu8_file_source(opts.filename, opts.chunksize)
        # like the reference: try the audio-file reader first, fall back to
        # raw CF32 (apps/SoapySDR.hs:172-179 initFileSource).  Header-only
        # probe — a multi-GB capture must not be read twice.
        try:
            from ..io.wav import probe_wav
            probe_wav(opts.filename)
            return SRC.wav_iq_source(opts.filename, opts.chunksize)
        except Exception:
            return SRC.cf32_file_source(opts.filename, opts.chunksize)
    devs = [d.get("driver") for d in SRC.enumerate_devices()]
    if not devs:
        print("No SDR devices detected")
        return None
    print(f"Available devices: {devs}")
    if opts.devname not in devs:
        print(f"Device {opts.devname} not found")
        return None
    print(f"Using device: {opts.devname}")
    try:
        kw = {}
        if opts.devname == "synthetic" and opts.numsamples:
            # a real radio streams until -n trims; the synthetic device has a
            # finite default length — size it to the request so `-n` beyond
            # the default is honored instead of silently short-delivering
            kw["total_samples"] = int(opts.numsamples)
        if opts.devname == "rtl_tcp":
            # protocol-depth passthrough (io/rtl_tcp.py round-3 surface)
            if getattr(opts, "ppm", 0):
                kw["ppm"] = opts.ppm
            if getattr(opts, "bias_t", False):
                kw["bias_t"] = True
        return iter(SRC.open_sdr(opts.devname, opts.samplerate, opts.frequency,
                                 opts.gain, **kw))
    except (OSError, ConnectionError) as e:
        # graceful device failure like the reference's device-absent path
        # (apps/SoapySDR.hs:159-170) — no traceback for an unplugged bridge
        print(f"Failed to open device {opts.devname}: {e}")
        return None


def _announce(label: str, graph, opts):
    """--verbose: per-block config lines, like the reference's liquid
    ``*_print`` on every object construction (SURVEY.md §5)."""
    if not getattr(opts, "verbose", False):
        return
    from ..core.block import Chain
    blocks = graph.blocks if isinstance(graph, Chain) else [graph]
    print(f"{label} (rate {graph.rate}, granule {graph.granule}):")
    for b in blocks:
        print(f"  {b!r}")


def run_opts(opts) -> int:
    demod = parse_demod(opts.demod)
    nch = opts.channels
    out_bw = opts.bandwidth if opts.bandwidth else opts.samplerate
    agc_t = opts.agc if opts.agc != 0.0 else None

    src = _open_source(opts)
    if src is None:
        print(f"Unable to open source")
        return 1

    # front end: offset mixer + resampler, then exact-N trim (the reference's
    # prep = takeNArr ns . process, apps/SoapySDR.hs:206-207)
    from ..models.receivers import front_end
    fe_stages = front_end(opts.samplerate, opts.offset, opts.bandwidth)
    if opts.filename and opts.filename.endswith(".cu8"):
        fe_stages = [B.u8_to_iq()] + fe_stages
    if fe_stages:
        fe = chain(*fe_stages) if len(fe_stages) > 1 else fe_stages[0]
        _announce("Front end", fe, opts)
        fe_pipe = Pipeline(fe, block_size=opts.blocksize)
        stream = fe_pipe.stream(src)
    else:
        stream = src
    from ..core.runtime import take_n
    stream = take_n(stream, opts.numsamples)

    if opts.spectrum is not None or opts.constellation is not None:
        # host-side IQ tap after the front end: the plot sinks are host code,
        # so tapping the already-downloaded stream costs no device work and
        # composes with every flow (incl. --mesh).  Makes the reference's
        # inspectrum/baudline eyeball step (README.md:126-146) one flag.
        taps = []
        if opts.spectrum is not None:
            taps.append(S.SpectrumPlotSink(
                opts.spectrum or f"{opts.output}_spectrum.m",
                sample_rate=out_bw))
        if opts.constellation is not None:
            taps.append(S.ConstellationPlotSink(
                opts.constellation or f"{opts.output}_constellation.m"))

        def _tapped(it, sinks):
            try:
                for blk in it:
                    for s in sinks:
                        s(blk)
                    yield blk
            finally:
                for s in sinks:
                    s.close()
        stream = _tapped(stream, taps)

    if opts.mesh and demod[0] == "DeNBFM" and nch > 1 and not opts.mix:
        # flagship: the hand-sharded channelized FM receiver
        return _run_sharded(opts, demod, stream, out_bw, agc_t)

    agc_blocks = [B.automatic_gain_control(agc_t)] if agc_t else []

    def audio_sink_rate(decim: int) -> int:
        return int(round(out_bw)) // decim // nch

    def with_play(sink, rate, channels: int):
        """--play: tee single-stream audio into a live player as well."""
        if opts.play is None or rate is None:
            return sink
        return S.TeeSink(sink, S.PlaybackSink(rate, channels,
                                              opts.play or None))

    play_rate = None  # set per demod kind where the output is mono audio
    kind = demod[0]
    if kind == "DeNo":
        per = chain(*agc_blocks) if agc_blocks else None
        make_sink = lambda name: S.RawFileSink(name + ".cf32")
    elif kind == "DeNBFM":
        _, kf, fmt = demod
        per = chain(*agc_blocks, B.fm_demodulator(kf))
        make_sink = lambda name: S.AudioFileSink(name, audio_sink_rate(1), 1, fmt.lower())
        play_rate = audio_sink_rate(1)
    elif kind == "DeWBFM":
        _, decim, fmt = demod
        per = chain(*agc_blocks, B.wbfm_demodulator(out_bw, decim))
        make_sink = lambda name: S.AudioFileSink(name, audio_sink_rate(decim), 1, fmt.lower())
        play_rate = audio_sink_rate(decim)
    elif kind == "DeAM":
        _, fmt = demod
        per = chain(*agc_blocks, B.am_demodulator())
        make_sink = lambda name: S.AudioFileSink(name, audio_sink_rate(1), 1, fmt.lower())
        play_rate = audio_sink_rate(1)
    elif kind in ("DeUSB", "DeLSB"):
        _, bw_hz, fmt = demod
        chan_rate = out_bw / nch  # SSB bandwidth normalized per channel
        per = chain(*agc_blocks,
                    B.ssb_demodulator("usb" if kind == "DeUSB" else "lsb",
                                      bw_hz / chan_rate))
        make_sink = lambda name: S.AudioFileSink(name, audio_sink_rate(1), 1, fmt.lower())
        play_rate = audio_sink_rate(1)
    elif kind == "DeCW":
        _, bw_hz, pitch_hz, fmt = demod
        chan_rate = out_bw / nch
        per = chain(*agc_blocks,
                    B.cw_demodulator(bw_hz / chan_rate, pitch_hz / chan_rate))
        make_sink = lambda name: S.AudioFileSink(name, audio_sink_rate(1), 1, fmt.lower())
        play_rate = audio_sink_rate(1)
    elif kind == "DeNBFMSync":
        _, k = demod
        from ..models.symsync import fm_dem_with_sync
        per = chain(*agc_blocks, fm_dem_with_sync(k))
        make_sink = lambda name: S.RawFileSink(name + ".f32")
    elif kind in ("DeAIS", "DeAPRS", "DeADSB", "DePOCSAG", "DeRTTY"):
        # packet flows (extensions): device chain → CollectSink → host-side
        # HDLC/AX.25/M.1371 (or Mode S CRC-24 / POCSAG BCH / ITA2) decode →
        # <output>.*.txt
        if nch != 1:
            print(f"{kind} does not support channel splitting")
            return 1
        chan_rate = out_bw
        bit_sink = S.CollectSink()
        try:
            if kind == "DeAIS":
                from ..models.ais import ais_receiver
                per = chain(*agc_blocks, ais_receiver(chan_rate))
            elif kind == "DeADSB":
                from ..models.adsb import adsb_receiver
                # the envelope detector IS the gain normalizer — no AGC
                per = chain(adsb_receiver(chan_rate))
            elif kind == "DePOCSAG":
                from ..models.pocsag import pocsag_receiver
                per = chain(*agc_blocks, pocsag_receiver(chan_rate, demod[1]))
            elif kind == "DeRTTY":
                # the authentic HF receive chain: tuned IQ → USB voice-band
                # audio → dual-tone discriminator
                from ..models.rtty import rtty_receiver
                per = chain(*agc_blocks,
                            B.ssb_demodulator("usb", 3000.0 / chan_rate),
                            rtty_receiver(chan_rate, demod[1]))
            else:
                from ..models.aprs import afsk1200_receiver
                per = chain(*agc_blocks, B.fm_demodulator(demod[1]),
                            afsk1200_receiver(chan_rate))
        except ValueError as e:
            print(e)
            return 1
        if opts.mesh:
            rc = _run_sharded_generic(opts, kind, per, None, stream,
                                      out_sink=bit_sink, dc=False)
            if rc:
                return rc
        else:
            _announce("Flow", per, opts)
            Pipeline(per, block_size=opts.blocksize).run(stream, bit_sink)
        if kind == "DeAIS":
            from ..models.ais import decode_bits
            msgs = decode_bits(np.asarray(bit_sink.concat()))
            lines = [
                (f"type {m['type']} mmsi {m['mmsi']:09d} "
                 f"lat {m['lat_deg']:+.5f} lon {m['lon_deg']:+.5f} "
                 f"sog {m['sog_kn']:.1f} cog {m['cog_deg']:.1f}"
                 if "lat_deg" in m else f"type {m['type']} mmsi {m['mmsi']:09d}")
                for m in msgs]
            suffix = ".ais.txt"
        elif kind == "DeADSB":
            from ..models.adsb import decode_collected, pair_positions
            from .adsb_decode import format_msg
            msgs = pair_positions(decode_collected(bit_sink.concat(), chan_rate))
            lines = [format_msg(m) for m in msgs]
            suffix = ".adsb.txt"
        elif kind == "DePOCSAG":
            from ..models.pocsag import decode_score
            from .pocsag_decode import format_msg
            msgs = decode_score(np.asarray(bit_sink.concat()), chan_rate,
                                demod[1])
            lines = [format_msg(m) for m in msgs]
            suffix = ".pocsag.txt"
        elif kind == "DeRTTY":
            from ..models.rtty import decode_score as rtty_decode
            text = rtty_decode(np.asarray(bit_sink.concat()), chan_rate,
                               demod[1])
            msgs = [ln for ln in text.splitlines() if ln.strip()]
            lines = msgs
            suffix = ".rtty.txt"
        else:
            from ..models.aprs import decode_score
            msgs = decode_score(np.asarray(bit_sink.concat()), chan_rate)
            lines = [f"{m['src']}>{m['dst']}"
                     + (("," + ",".join(m["via"])) if m["via"] else "")
                     + f":{m['info']}" for m in msgs]
            suffix = ".aprs.txt"
        for ln in lines:
            print(ln)
        print(f"{len(msgs)} message(s)")
        with open(opts.output + suffix, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        return 0
    elif kind == "DeFMS":
        _, decim, fmt = demod
        from ..models.stereo import stereo_fm_decoder
        if nch != 1:
            print("DeFMS does not support channel splitting")
            return 1
        per = chain(*agc_blocks, B.fm_demodulator(0.8),
                    stereo_fm_decoder(out_bw, decim))
        sink = with_play(
            S.AudioFileSink(opts.output, audio_sink_rate(decim), 2,
                            fmt.lower()),
            audio_sink_rate(decim), 2)
        if opts.rds:
            # decode the 57 kHz RDS subcarrier alongside the stereo audio
            # (capability extension — models/rds.py).  One pipeline: the
            # demodulated composite feeds a multi-rate Tee (stereo at
            # 1/decim, RDS bits at 19/3840) — no host materialization; each
            # branch is trimmed by its own rational rate (core/runtime).
            from ..core.block import Tee
            from ..models.rds import rds_receiver, decode_groups

            bit_sink = S.CollectSink()
            graph = chain(B.dc_blocker(), *agc_blocks, B.fm_demodulator(0.8),
                          Tee(stereo_fm_decoder(out_bw, decim),
                              rds_receiver(out_bw)))
            if opts.mesh:
                # the multi-rate Tee shards too: per-branch out_specs carry
                # per-leaf local lengths (core/block.Tee.shard_validate) and
                # the sharded runner trims each leaf by its own rate
                from ..parallel.generic import ShardedChain
                from ..parallel.runner import ShardedPipeline

                mesh = _mesh_of(opts)
                if mesh is None:
                    return 1
                block = _sharded_block(mesh, graph, opts.blocksize)
                try:
                    sh = ShardedChain(graph, mesh, block)
                except NotImplementedError as e:
                    print(f"--mesh: this flow cannot be time-sharded ({e})")
                    return 1
                except ValueError as e:
                    print(f"--mesh: invalid configuration ({e})")
                    return 1
                _announce("Flow", graph, opts)
                with sink:
                    ShardedPipeline(sh).run(stream,
                                            S.BranchSinks(sink, bit_sink))
            else:
                pipe = Pipeline(graph, block_size=opts.blocksize,
                                profile=getattr(opts, "profile", False))
                with sink:
                    pipe.run(stream, S.BranchSinks(sink, bit_sink))
                _profile_summary(pipe, opts)
            info = decode_groups(bit_sink.concat())
            pi = f"{info['pi']:04X}" if info["pi"] is not None else "----"
            print(f"RDS: PI={pi} PS={info['ps']!r} RT={info['rt']!r} "
                  f"({info['groups']} groups)")
            with open(opts.output + ".rds.txt", "w") as f:
                f.write(f"PI: {pi}\nPS: {info['ps']}\nRT: {info['rt']}\n"
                        f"groups: {info['groups']}\n")
            return 0
        if opts.mesh:
            # the closed-form-PLL stereo graph time-shards like any other
            # composition (models/stereo.StereoFMDecoder.shard_apply); the
            # scan-PLL mode refuses inside shard_validate with a clear message
            return _run_sharded_generic(opts, kind, per, None, stream,
                                        out_sink=sink)
        graph = chain(B.dc_blocker(), per)
        pipe = Pipeline(graph, block_size=opts.blocksize,
                        profile=getattr(opts, "profile", False))
        with sink:
            pipe.run(stream, sink)
        _profile_summary(pipe, opts)
        return 0
    else:
        raise AssertionError(kind)

    if opts.play is not None and (play_rate is None
                                  or (nch > 1 and not opts.mix)):
        print("--play ignored: output is not a single audio stream")

    if opts.mesh:
        # generic compositional sharded path: the SAME graph the
        # single-device branch builds, run under shard_map
        # (parallel/generic.ShardedChain) — any demod flow that its blocks
        # support shards; sequential blocks refuse with a clear message
        out_sink = (with_play(make_sink(opts.output), play_rate, 1)
                    if nch == 1 else None)
        return _run_sharded_generic(opts, kind, per, make_sink, stream,
                                    out_sink=out_sink)

    stages = [B.dc_blocker()]
    if nch > 1:
        stages.append(B.firpfbch_channelizer(nch))
        if per is not None:
            stages.append(PerChannel(per, nch))
        if opts.mix:
            stages.append(MixChannels())
            sink = with_play(make_sink(opts.output), play_rate, 1)
        else:
            sink = S.ChannelFileSinks(
                lambda i: make_sink(f"{opts.output}_ch{i + 1}"), nch)
    else:
        if per is not None:
            stages.append(per)
        sink = with_play(make_sink(opts.output), play_rate, 1)

    graph = chain(*stages)
    _announce("Flow", graph, opts)
    pipe = Pipeline(graph, block_size=opts.blocksize,
                    profile=getattr(opts, "profile", False))
    t0 = time.perf_counter()
    with sink:
        total = pipe.run(stream, sink)
    _summary(total, time.perf_counter() - t0, opts)
    _profile_summary(pipe, opts)
    print(f"Wrote {total} output samples per stream")
    return 0


def _profile_summary(pipe, opts):
    if getattr(opts, "profile", False) and getattr(pipe, "stage_stats", None):
        print("Per-stage budget (on-device time per block):")
        print(pipe.profile_report())


def _summary(total_out: int, dt: float, opts):
    if getattr(opts, "verbose", False) and dt > 0:
        print(f"Throughput: {total_out} output samples in {dt:.2f} s "
              f"({total_out / dt / 1e6:.2f} MSPS out, incl. compile)")


def _mesh_of(opts):
    import numpy as np
    import jax
    from jax.sharding import Mesh

    dt, dc = (int(v) for v in opts.mesh.lower().split("x"))
    devs = jax.devices()
    if dt * dc > len(devs):
        print(f"mesh {opts.mesh} needs {dt * dc} devices, have {len(devs)}")
        return None
    return Mesh(np.asarray(devs[:dt * dc]).reshape(dt, dc), ("time", "ch"))


def _sharded_block(mesh, graph, blocksize: int) -> int:
    """Round the requested block size to a multiple of time_shards·granule
    (ShardedChain's divisibility contract).  dt comes from the Mesh object
    itself so --mesh is parsed in exactly one place (_mesh_of)."""
    dt = mesh.devices.shape[0]
    g = graph.granule
    return max(blocksize // (dt * g), 1) * dt * g


def _run_sharded_generic(opts, kind, per, make_sink, stream,
                         out_sink=None, dc=True) -> int:
    """Any CLI flow over a Mesh('time','ch') via the compositional sharded
    runtime (parallel/generic.ShardedChain).  ``out_sink`` overrides the
    default sink selection (DeFMS passes its 2-channel audio sink);
    ``dc=False`` matches serial flows that skip the head DC blocker (the
    packet receivers) so mesh and serial runs execute the SAME graph."""
    from ..parallel.generic import ShardedChain
    from ..parallel.runner import ShardedPipeline

    mesh = _mesh_of(opts)
    if mesh is None:
        return 1
    nch = opts.channels
    stages = [B.dc_blocker()] if dc else []
    if nch > 1:
        stages.append(B.firpfbch_channelizer(nch))
        if per is not None:
            stages.append(PerChannel(per, nch))
        if opts.mix:
            stages.append(MixChannels())
            sink = make_sink(opts.output)
        else:
            sink = S.ChannelFileSinks(
                lambda i: make_sink(f"{opts.output}_ch{i + 1}"), nch)
    else:
        if per is not None:
            stages.append(per)
        sink = out_sink if out_sink is not None else make_sink(opts.output)
    graph = chain(*stages)
    _announce("Flow", graph, opts)
    block = _sharded_block(mesh, graph, opts.blocksize)
    try:
        sh = ShardedChain(graph, mesh, block)
    except NotImplementedError as e:
        print(f"--mesh: this flow cannot be time-sharded ({e})")
        return 1
    except ValueError as e:
        print(f"--mesh: invalid configuration ({e})")
        return 1
    runner = ShardedPipeline(sh)
    t0 = time.perf_counter()
    with sink:
        total = runner.run(stream, sink)
    _summary(total, time.perf_counter() - t0, opts)
    shape = "x".join(opts.mesh.lower().split("x"))
    print(f"Wrote {total} output samples per stream over mesh {shape}")
    return 0


def _run_sharded(opts, demod, stream, out_bw, agc_t) -> int:
    """Multi-device channelized FM receive over a Mesh('time','ch')
    (parallel/channelized.py) — the reference has no equivalent."""
    from ..parallel.channelized import ShardedChannelizedFM
    from ..parallel.runner import ShardedPipeline

    _, kf, fmt = demod
    mesh = _mesh_of(opts)
    if mesh is None:
        return 1
    dt, dc = mesh.devices.shape
    nch = opts.channels
    block = max(opts.blocksize // (dt * nch), 64) * dt * nch
    sh = ShardedChannelizedFM(mesh=mesh, nch=nch, block_size=block, kf=kf,
                              agc_threshold_db=agc_t)
    sink = S.ChannelFileSinks(
        lambda i: S.AudioFileSink(f"{opts.output}_ch{i + 1}",
                                  int(round(out_bw)) // nch, 1, fmt.lower()),
        nch)
    runner = ShardedPipeline(sh)
    with sink:
        total = runner.run(stream, sink)
    print(f"Wrote {total} output samples per channel over mesh {dt}x{dc}")
    return 0


def main(argv=None) -> int:
    from ..utils.compile_cache import enable_compile_cache

    opts = build_parser().parse_args(argv)
    enable_compile_cache()
    return run_opts(opts)


if __name__ == "__main__":
    sys.exit(main())
