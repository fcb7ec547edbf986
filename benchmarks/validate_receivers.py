"""Device validation of the receiver fleet.

Every receiver (SSB/CW, Morse, AIS, APRS, ADS-B, POCSAG, RTTY, RDS, APT,
SSTV, beacon, WEFAX) is tested on CPU oracles; the reference ran every
capability on real hardware (/root/reference/README.md:126-205).  This
script runs each receiver's synthetic-signal flow on the device JAX finds —
the same flows the test suite uses, device side executed by the jitted
Pipeline, host side the packet/text decoders — and records a per-receiver
verdict with a decode metric and the device it ran on.

    python benchmarks/validate_receivers.py [out.json]

Off the GPU the script exits non-zero (the tests run the same validators on
the CPU).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

def _run(graph, x, block_size):
    import csdr_tpu as cs

    snk = cs.CollectSink()
    cs.Pipeline(graph, block_size=block_size).run(iter([x]), snk)
    return np.asarray(snk.concat())


def _snr_db(want, got):
    e = got - want
    return 10.0 * np.log10(np.sum(want ** 2) / max(np.sum(e ** 2), 1e-30))


def val_ssb():
    import scipy.signal as sig
    import csdr_tpu as cs

    FS = 48_000.0
    n = 1 << 16
    t = np.arange(n) / FS
    tones = (400.0, 1000.0, 2300.0)
    audio = sum(np.sin(2 * np.pi * f * t + 0.7 * i)
                for i, f in enumerate(tones)) / len(tones)
    rows = []
    for side in ("usb", "lsb"):
        analytic = sig.hilbert(audio)
        x = (0.5 * (analytic if side == "usb" else np.conj(analytic))
             ).astype(np.complex64)
        dem = cs.ssb_demodulator(side, bandwidth=3000.0 / FS)
        y = _run(dem, x, 8192)
        gd = dem.blocks[0].tail_len // 2
        lo, hi = 4096, n - gd - 4096
        snr = _snr_db(audio[lo:hi], y[lo + gd:hi + gd].astype(np.float64))
        rows.append(round(float(snr), 1))
    return {"name": "ssb", "ok": all(s > 35.0 for s in rows),
            "recovery_snr_db_usb_lsb": rows}


def val_cw_morse():
    from csdr_tpu.models import morse

    FS = 8000.0
    text = "CSDR SDR 73"
    wpm = 20.0
    unit = int(round(FS * 1.2 / wpm))
    key = []
    for word in text.split(" "):
        for ch in word:
            for el in morse._CODE[ch]:
                key += [1] * (unit if el == "." else 3 * unit) + [0] * unit
            key += [0] * (2 * unit)
        key += [0] * (4 * unit)
    key = np.array([0] * (2 * unit) + key + [0] * (2 * unit), np.float32)
    t = np.arange(len(key))
    # 30 Hz mistuning, inside the 100 Hz envelope filter (a 500 Hz offset
    # falls outside it and decodes garbage — validator bug, not the model's)
    rng = np.random.default_rng(0)
    iq = (key * np.exp(2j * np.pi * (30.0 / FS) * t)
          + 0.03 * (rng.normal(size=len(key))
                    + 1j * rng.normal(size=len(key)))).astype(np.complex64)
    env = _run(morse.cw_envelope(100.0 / FS), iq, 1 << 14)
    got = morse.decode_envelope(env)
    return {"name": "morse_cw", "ok": got == text, "decoded": got,
            "sent": text}


def val_ais():
    from csdr_tpu.models import ais

    FS = 48000.0
    k = int(FS // 9600)
    reports = [
        ais.make_position_report(257123456, 59.91234, 10.75321, 14.2, 83.1),
        ais.make_position_report(366998410, -33.85678, 151.21543, 0.3, 201.5,
                                 msg_type=3),
    ]
    idle = np.array([0, 1] * 40, np.uint8)
    levels = np.concatenate(
        [idle] + sum(([ais.ais_burst_bits(r), idle] for r in reports), []))
    iq = ais.ais_modulate(levels, k).astype(np.complex64)
    rng = np.random.default_rng(1)
    iq = iq + 0.02 * (rng.normal(size=len(iq))
                      + 1j * rng.normal(size=len(iq))).astype(np.complex64)
    msgs = ais.decode_bits(_run(ais.ais_receiver(FS), iq, 4096 * k))
    ok = (len(msgs) == 2 and msgs[0]["mmsi"] == 257123456
          and abs(msgs[0]["lat_deg"] - 59.91234) < 1e-5)
    return {"name": "ais", "ok": bool(ok), "frames_sent": 2,
            "frames_decoded": len(msgs)}


def val_aprs():
    from csdr_tpu.models import aprs

    FS = 48000.0
    frames = [
        aprs.make_ax25_ui("N0CALL-7", "APRS", "!4903.50N/07201.75W-Test"),
        aprs.make_ax25_ui("K1ABC", "BEACON", ">status: all systems nominal",
                          via=("WIDE1-1",)),
    ]
    idle = np.ones(96, np.uint8)
    levels = np.concatenate(
        [idle] + sum(([aprs.aprs_burst_bits(f), idle] for f in frames), []))
    audio = aprs.afsk_modulate(levels, FS)
    score = _run(aprs.afsk1200_receiver(FS), audio, 1 << 15)
    msgs = aprs.decode_score(score, FS)
    ok = len(msgs) == 2 and msgs[0]["src"].startswith("N0CALL")
    return {"name": "aprs", "ok": bool(ok), "frames_sent": 2,
            "frames_decoded": len(msgs)}


def val_adsb():
    from csdr_tpu.models import adsb

    FS = 2e6
    icao, lat, lon = 0x4840D6, 52.25720, 3.91937
    frames = [
        adsb.make_es_ident(icao, "KLM1023"),
        adsb.make_es_position(icao, lat, lon, 38000, odd=False),
        adsb.make_es_position(icao, lat, lon, 38000, odd=True),
        adsb.make_es_velocity(icao, 120.0, 209.0, vrate_fpm=640),
    ]
    k = int(FS // 1e6)
    gap = np.zeros(40 * k, np.float32)
    mag = np.concatenate(
        [gap] + sum(([adsb.adsb_modulate(f, FS), gap] for f in frames), []))
    iq = adsb.to_iq(mag)
    rng = np.random.default_rng(1)
    iq = (iq + 0.02 * (rng.normal(size=len(iq))
                       + 1j * rng.normal(size=len(iq)))).astype(np.complex64)
    collected = _run(adsb.adsb_receiver(FS), iq, 4096)
    msgs = adsb.pair_positions(adsb.decode_collected(collected, FS))
    ok = (len(msgs) == 4 and msgs[0].get("callsign") == "KLM1023"
          and abs(msgs[2]["lat_deg"] - lat) < 3e-4)
    return {"name": "adsb", "ok": bool(ok), "frames_sent": 4,
            "frames_decoded": len(msgs)}


def val_pocsag():
    from csdr_tpu.models import pocsag as pg

    FS = 38400.0
    lv = pg.make_transmission(1234568, "CSDR PAGER OK")
    iq = pg.pocsag_modulate(lv, FS)
    score = _run(pg.pocsag_receiver(FS), iq, 1 << 14)
    msgs = pg.decode_score(score, FS)
    ok = len(msgs) >= 1 and msgs[0]["text"] == "CSDR PAGER OK" \
        and msgs[0]["ric"] == 1234568
    return {"name": "pocsag", "ok": bool(ok),
            "decoded": msgs[0]["text"] if msgs else None}


def val_rtty():
    from csdr_tpu.models import rtty

    FS = 8000.0
    MSG = "RYRY DE CSDR JAX 599"
    audio = rtty.rtty_modulate(MSG, FS)
    score = _run(rtty.rtty_receiver(FS), audio, 1 << 14)
    got = rtty.decode_score(score, FS)
    return {"name": "rtty", "ok": got == MSG, "decoded": got, "sent": MSG}


def val_rds():
    import csdr_tpu as cs
    from csdr_tpu.models import rds

    quad = 192000.0
    pi, ps = 0x52D4, "CSDR-JAX"
    rt = "JAX NATIVE RADIO"
    groups = [rds.make_group_0a(pi, s, ps[2 * s:2 * s + 2]) for s in range(4)]
    groups += [rds.make_group_2a(pi, s, rt[4 * s:4 * s + 4]) for s in range(4)]
    g = rds.rds_receiver(quad)
    n = (int(quad * 1.6) // g.granule) * g.granule
    t = np.arange(n) / quad
    L = 0.6 * np.sin(2 * np.pi * 800.0 * t)
    R = 0.6 * np.sin(2 * np.pi * 2500.0 * t)
    ph = 2 * np.pi * 19000.0 * t + 0.7
    mpx = 0.45 * (L + R) + 0.1 * np.cos(ph) + 0.45 * (L - R) * np.cos(2 * ph)
    tx = rds.bits_from_groups(groups)
    bit_idx = np.floor(t * rds.RDS_BAUD).astype(np.int64) % len(tx)
    half = np.floor(t * 2 * rds.RDS_BAUD).astype(np.int64) % 2
    lvl = (tx[bit_idx] * 2.0 - 1.0) * np.where(half == 0, 1.0, -1.0)
    mpx = (mpx + 0.12 * lvl * np.cos(3 * ph)).astype(np.float32)
    bits = _run(g, mpx, g.granule * max(1, (1 << 16) // g.granule))
    out = rds.decode_groups(bits)
    ok = out["pi"] == pi and out["ps"] == ps and out["rt"] == rt.rstrip()
    return {"name": "rds", "ok": bool(ok), "groups": out["groups"],
            "ps": out["ps"], "pi": out["pi"]}


def val_apt():
    from csdr_tpu.models import apt

    FS = 8 * apt.WORD_RATE
    lines = 6
    rng = np.random.default_rng(3)
    img = np.zeros((lines, apt.LINE_WORDS), np.float64)
    t = np.arange(909)
    for ln in range(lines):
        img[ln, :39] = apt.SYNC_A * 233 + 11
        img[ln, 39:86] = 11
        img[ln, 86:995] = 128 + 100 * np.sin(
            2 * np.pi * (ln + 1) * t / 909 + rng.uniform(0, np.pi))
        img[ln, 995:] = 60
    img = np.asarray(np.rint(img), np.uint8)
    audio = apt.apt_modulate(img, FS)
    words = _run(apt.apt_receiver(FS), audio, 1 << 16)
    got, info = apt.decode_words(words)
    va_got, _ = apt.split_channels(got)
    s0 = int(info["syncs"][0]) if info["lines"] else 0
    first = s0 // apt.LINE_WORDS + (1 if s0 % apt.LINE_WORDS > 39 else 0)
    n = min(len(va_got), lines - first)
    err = (np.abs(va_got[:n].astype(float)
                  - img[first:first + n, 86:995].astype(float))
           if n else np.asarray([255.0]))
    ok = info["lines"] >= lines - 2 and float(np.median(err)) <= 3.0
    return {"name": "apt", "ok": bool(ok), "lines": info["lines"],
            "median_err": round(float(np.median(err)), 2)}


def val_sstv():
    from csdr_tpu.models import sstv

    FS = 11025.0
    rng = np.random.default_rng(7)
    lines, px = 4, 320
    t = np.arange(px)
    img = np.zeros((lines, px, 3), np.float64)
    for ln in range(lines):
        img[ln, :, 0] = 128 + 100 * np.sin(2 * np.pi * t / px + ln)
        img[ln, :, 1] = np.clip(255 * t / px, 0, 255)
        img[ln, :, 2] = 60 + 30 * np.cos(4 * np.pi * t / px + rng.uniform())
    img = np.asarray(np.rint(img), np.uint8)
    audio = sstv.sstv_modulate(img, FS, mode="martin1")
    freq = _run(sstv.sstv_receiver(FS), audio.astype(np.float32), 1 << 15)
    got, info = sstv.decode_freq(freq, FS)
    n = min(len(got), lines)
    err = (np.abs(got[:n].astype(float) - img[:n].astype(float))
           if n else np.asarray([255.0]))
    ok = (info["mode"] == "martin1" and info["lines"] >= lines - 1
          and float(np.median(err)) <= 4.0)
    return {"name": "sstv", "ok": bool(ok), "mode": info["mode"],
            "lines": info["lines"],
            "median_err": round(float(np.median(err)), 2)}


def val_beacon():
    import jax
    from csdr_tpu.models import beacon

    rng = np.random.default_rng(11)
    tone_host = lambda v: np.asarray(beacon.tone_energies(v, 64))
    msg = rng.integers(0, 2, beacon.MESSAGE_BITS)
    x = beacon.beacon_modulate(msg, spsym=64)
    sigma = np.sqrt(10.0 ** (1.3) / 2.0)          # -13 dB SNR
    noisy = (x + sigma * (rng.normal(size=len(x))
                          + 1j * rng.normal(size=len(x)))).astype(np.complex64)
    # device half on the real chip: tone energies via the MXU matmul,
    # complex-free boundary (ship planes, assemble inside jit)
    planes = np.stack([noisy.real, noisy.imag], -1).astype(np.float32)
    e_dev = np.asarray(jax.jit(
        lambda p: beacon.tone_energies_device(p, 64))(planes))
    # host half: the full sync-search + Viterbi decode path
    got, info = beacon.beacon_decode(noisy, spsym=64)
    ok = (got is not None and np.array_equal(got, msg)
          and np.allclose(e_dev[:8], tone_host(noisy)[:8], rtol=1e-3))
    return {"name": "beacon", "ok": bool(ok), "snr_db": -13.0,
            "crc_ok": bool(info.get("crc_ok"))}


def val_wefax():
    from csdr_tpu.models import wefax

    FS = 12000.0
    rng = np.random.default_rng(13)
    t = np.arange(wefax.PX_PER_LINE)
    img = np.zeros((4, wefax.PX_PER_LINE), np.float64)
    for ln in range(4):
        img[ln] = 200 - 150 * (0.5 + 0.5 * np.sin(
            2 * np.pi * (ln + 2) * t / wefax.PX_PER_LINE + rng.uniform()))
    img = np.asarray(np.rint(img), np.uint8)
    audio = wefax.wefax_modulate(img, FS)
    freq = _run(wefax.wefax_receiver(FS), audio.astype(np.float32), 1 << 16)
    got, info = wefax.decode_freq(freq, FS)
    n = min(len(got), 4)
    err = (np.abs(got[:n].astype(float) - img[:n].astype(float))
           if n else np.asarray([255.0]))
    ok = info["lines"] >= 3 and float(np.median(err)) <= 4.0
    return {"name": "wefax", "ok": bool(ok), "lines": info["lines"],
            "median_err": round(float(np.median(err)), 2),
            "phasing_score": round(info["phasing_score"], 3)}


VALIDATORS = [val_ssb, val_cw_morse, val_ais, val_aprs, val_adsb,
              val_pocsag, val_rtty, val_rds, val_apt, val_sstv, val_beacon,
              val_wefax]


def main():
    import bench

    bench.require_gpu()
    dev = bench.device_info()
    rows = []
    for fn in VALIDATORS:
        t0 = time.perf_counter()
        try:
            row = fn()
        except Exception as e:
            row = {"name": fn.__name__[4:], "ok": False,
                   "error": f"{type(e).__name__}: {e}"[:300]}
        row["secs"] = round(time.perf_counter() - t0, 1)
        rows.append(row)
        print(json.dumps(row), flush=True)
    rec = {"ts": time.time(), "device": dev,
           "all_ok": all(r["ok"] for r in rows), "rows": rows}
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(rec, f, indent=1)
        print(f"# wrote {sys.argv[1]}")
    print(json.dumps({"metric": "receivers_ok",
                      "value": sum(r["ok"] for r in rows),
                      "total": len(rows), "device": dev}))


if __name__ == "__main__":
    main()
