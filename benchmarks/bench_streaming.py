"""End-to-end streaming benchmark: file → host feed → device graph → sinks.

bench.py times the device-resident flagship step; this times the served
path around it: a capture file read by the (native, when built) IO runtime,
host→device transfer, the channelized FM graph and per-channel file writes —
the analogue of the reference's 20-channel split workload (README.md:184-195:
1.6 MSPS real-time on one CPU core).

Usage: python benchmarks/bench_streaming.py [n_samples] [nch] [cu8] [decimK] [nodl] [allow-cpu]

``cu8`` feeds interleaved uint8 IQ (2 B/sample on the host wire, converted
on the device by u8_to_iq).  ``decimK`` (e.g. decim8) adds a per-channel
audio decimator.  ``nodl`` replaces the host sinks with an on-device
checksum over every block's output, so the number measures ingest
(host → device → demod) without the device → host return.  The metric is
INPUT samples/s in every variant; each timed window ends in
`block_until_ready`.  Off the GPU the script exits non-zero unless
``allow-cpu`` is given (a CPU run checks the mechanics, not a speed).
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_capture(path: str, n: int, cu8: bool) -> int:
    """Seeded tone + noise capture; returns the sample count written."""
    rng = np.random.default_rng(0)
    chunk = min(1 << 22, n)  # n below the writer chunk must not yield an
    n = (n // chunk) * chunk  # empty capture (a 0-block "benchmark")
    with open(path, "wb") as f:
        for t0 in range(0, n, chunk):
            t = np.arange(t0, t0 + chunk)
            x = (0.5 * np.exp(2j * np.pi * np.mod(0.1237 * t, 1.0))
                 + 0.05 * (rng.standard_normal(chunk)
                           + 1j * rng.standard_normal(chunk)))
            if cu8:
                u8 = np.empty(2 * chunk, dtype=np.uint8)
                u8[0::2] = np.clip(np.round(x.real * 127.5 + 127.5), 0, 255)
                u8[1::2] = np.clip(np.round(x.imag * 127.5 + 127.5), 0, 255)
                u8.tofile(f)
            else:
                x.astype(np.complex64).tofile(f)
    return n


def main():
    import jax
    import jax.numpy as jnp

    import bench
    import csdr_tpu as cs
    from csdr_tpu.core.runtime import rechunk
    from csdr_tpu.models.receivers import channelized_fm_receiver

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 25  # 33.5 MS
    nch = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    flags = set(sys.argv[3:])
    cu8 = "cu8" in flags
    nodl = "nodl" in flags
    decim = next((int(a[5:]) for a in flags if a.startswith("decim")), 1)
    if "allow-cpu" not in flags:
        bench.require_gpu()

    with tempfile.TemporaryDirectory() as td:
        cap = os.path.join(td, "cap.cu8" if cu8 else "cap.cf32")
        n = write_capture(cap, n, cu8)

        graph = channelized_fm_receiver(nch, kf=0.6, audio_decim=decim)
        if cu8:
            graph = cs.chain(cs.u8_to_iq(), graph)
        pipe = cs.Pipeline(graph, block_size=(1 << 23) if cu8 else (1 << 22))

        try:
            from csdr_tpu.io.native import NativeRawFileSink as Sink
            from csdr_tpu.io.native import native_cf32_source
            native = True
        except Exception:
            Sink = cs.RawFileSink
            native = False

        if cu8:
            src = cs.cu8_file_source(cap, 1 << 21)
        elif native:
            src = native_cf32_source(cap, 1 << 20)
        else:
            src = cs.cf32_file_source(cap, 1 << 20)

        if nodl:
            # full reduction over every output element, chained across
            # blocks so no block's demod work can be skipped
            acc = jax.jit(lambda tot, y: tot * jnp.float32(0.5) + sum(
                jnp.sum(l.ri if hasattr(l, "ri") else l)
                for l in jax.tree.leaves(y)))
            warm = np.zeros(pipe.block_size, np.uint8 if cu8 else np.complex64)
            jax.block_until_ready(acc(jnp.float32(0), pipe.process_block(warm)))
            pipe.reset()
            tot = jnp.float32(0)
            host_bytes = 0
            t0 = time.perf_counter()
            for chunk in rechunk(src, pipe.block_size):
                host_bytes += chunk.nbytes    # host-truth wire bytes
                if len(chunk) < pipe.block_size:
                    chunk = np.pad(chunk, (0, pipe.block_size - len(chunk)))
                tot = acc(tot, pipe.process_block(chunk))
            checksum = float(jax.block_until_ready(tot))
            dt = time.perf_counter() - t0
            assert np.isfinite(checksum)
            total = n // nch // decim
        else:
            sink = cs.ChannelFileSinks(
                lambda i: Sink(os.path.join(td, f"out_ch{i + 1}.f32")), nch)
            t0 = time.perf_counter()
            total = pipe.run(src, sink)
            sink.close()
            dt = time.perf_counter() - t0

        msps = n / dt / 1e6
        rec = {
            "metric": ("streaming_end_to_end_pfb_fm"
                       + ("_cu8" if cu8 else "")
                       + (f"_decim{decim}" if decim > 1 else "")
                       + ("_nodl" if nodl else "")),
            "value": msps,
            "unit": "Msamples/s",
            "nch": nch,
            "device": bench.device_info(),
            "native_io": native,
            "output_samples_per_channel": total,
            "seconds": dt,
        }
        if nodl:
            rec["sinks"] = "on-device chained checksum"
            rec["checksum"] = checksum
            rec["host_feed_MBps"] = host_bytes / dt / 1e6
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
