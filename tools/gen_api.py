"""Regenerate docs/API.md from the package's public surface.

Usage: python tools/gen_api.py  (writes docs/API.md in place).

Each section lists the module's public callables/classes as
``- **`name(signature)`** — first docstring line``, matching the hand-written
round-1 format.  Keep sections in sync with the package layout; this exists
so the API reference cannot silently go stale again (round-2 modules were
missing from the hand-maintained file).
"""

from __future__ import annotations

import inspect
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc1(obj) -> str:
    # for classes, use the class's OWN docstring (getdoc falls back to the
    # base class — every Block subclass would read "Base class...")
    d = obj.__doc__ if inspect.isclass(obj) else inspect.getdoc(obj)
    if not d:
        return ""
    # first paragraph, collapsed to one line, capped
    para = d.split("\n\n")[0].replace("\n", " ").strip()
    return para if len(para) <= 400 else para[:397] + "..."


def _entry(name: str, obj) -> str:
    if inspect.isclass(obj):
        try:
            sig = str(inspect.signature(obj.__init__))
            sig = "(" + sig.split("(", 1)[1].replace("self, ", "").replace(
                "self", "")
        except (ValueError, TypeError):
            sig = ""
        head = f"`{name}{sig}`" if sig and sig != "()" else f"`{name}`"
    else:
        head = f"`{name}{_sig(obj)}`"
    doc = _doc1(obj)
    return f"- **{head}** — {doc}" if doc else f"- **{head}**"


def section(title: str, module, names=None, out=None):
    out.append(f"\n## {title}\n")
    if names is None:
        names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n, o in vars(module).items()
                 if not n.startswith("_")
                 and (inspect.isfunction(o) or inspect.isclass(o))
                 and getattr(o, "__module__", "").startswith("csdr_tpu")]
    for n in names:
        obj = getattr(module, n, None)
        if obj is None or not callable(obj):
            continue
        out.append(_entry(n, obj))


def main():
    import csdr_tpu as cs
    from csdr_tpu import blocks, io as cio, models
    from csdr_tpu.models import adsb, ais, aprs, apt, beacon, sstv, wefax, hdlc, modem, morse, pocsag, receivers, rds, rtty, stereo, symsync
    from csdr_tpu import parallel
    from csdr_tpu.parallel import generic as pgeneric, channelized, mesh, runner
    from csdr_tpu.core import block as cblock, runtime, checkpoint, sharding
    from csdr_tpu.utils import firdes, iirdes, testsig, prof, reference, compile_cache
    from csdr_tpu.io import rtl_tcp, soapy, sources, sinks
    from csdr_tpu.ops import fec, fir as ops_fir

    out = ["# API reference (auto-generated — `python tools/gen_api.py`)\n"]

    section("Top level (`import csdr_tpu as cs`): core", cblock,
            ["Block", "Chain", "chain", "Lambda", "Tee", "PerChannel",
             "MixChannels", "Delay"], out)
    out.append(_entry("Pipeline", runtime.Pipeline))
    out.append(_entry("rechunk", runtime.rechunk))
    out.append(_entry("take_n", runtime.take_n))
    out.append(_entry("skip_n", runtime.skip_n))

    section("Top level: DSP blocks", blocks, None, out)
    section("Top level: IO", cs,
            ["cf32_file_source", "cu8_file_source", "f32_file_source",
             "wav_iq_source", "SdrSource", "SyntheticSdrSource",
             "enumerate_devices", "open_sdr", "RawFileSink", "StdoutSink",
             "AudioFileSink", "ConstellationPlotSink", "SpectrumPlotSink", "ChannelFileSinks",
             "NullSink", "CollectSink", "PlaybackSink", "TeeSink",
             "BranchSinks"], out)
    section("io.sources (extras)", sources,
            ["raw_bytes_source", "register_sdr_driver"], out)
    section("io.rtl_tcp (network SDR driver)", rtl_tcp, None, out)
    section("io.soapy (gated SoapySDR binding)", soapy, None, out)
    section("models.receivers", receivers, None, out)
    section("models.stereo", stereo, None, out)
    section("models.symsync", symsync, None, out)
    section("models.rds", rds, None, out)
    section("models.modem", modem, None, out)
    section("models.ais (AIS receiver)", ais, None, out)
    section("models.aprs (APRS/AFSK1200 receiver)", aprs, None, out)
    section("models.hdlc (shared HDLC bit layer)", hdlc, None, out)
    section("models.morse (CW decoder)", morse, None, out)
    section("models.adsb (ADS-B / Mode S receiver)", adsb, None, out)
    section("models.pocsag (POCSAG pager receiver)", pocsag, None, out)
    section("models.rtty (RTTY/ITA2 receiver)", rtty, None, out)
    section("models.apt (NOAA APT weather-image receiver)", apt, None, out)
    section("models.sstv (SSTV Martin image receiver)", sstv, None, out)
    section("models.beacon (coded 4-FSK weak-signal beacon)", beacon, None, out)
    section("models.wefax (HF radiofax chart receiver)", wefax, None, out)
    section("parallel (multi-chip runtimes)", parallel, None, out)
    section("parallel.generic (any-chain sharding)", pgeneric, None, out)
    section("core.sharding (per-block sharding protocol)", sharding, None, out)
    section("core.checkpoint", checkpoint, None, out)
    section("core.runtime (boundary codec)", runtime,
            ["CEnc", "resume_pipeline"], out)
    section("ops.fec (convolutional FEC / Viterbi)", fec, None, out)
    section("ops.fir (streaming FIR engines)", ops_fir, None, out)
    section("utils.firdes", firdes, None, out)
    section("utils.iirdes", iirdes, None, out)
    section("utils.testsig", testsig, None, out)
    section("utils.prof", prof, None, out)
    section("utils.reference (float64 reference of the flagship chain)", reference, None, out)
    section("utils.compile_cache", compile_cache, None, out)

    path = os.path.join(os.path.dirname(__file__), "..", "docs", "API.md")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    print(f"wrote {os.path.normpath(path)}: {len(out)} lines")


if __name__ == "__main__":
    main()
