"""Symbol-sync throughput: block-parallel estimator vs closed-loop scan.

The scan mode is a serial
lax.scan per output tick (liquid-faithful dynamics) and is expected to be
orders of magnitude slower than the block-parallel path — this script
quantifies the gap so users know what choosing mode="scan" costs.

    python benchmarks/bench_symsync.py [--k 4] [--nsym 65536] [--reps 5]

Prints one JSON line per mode with MSPS (input samples/s) and the device;
each timed window ends in `block_until_ready`.  Off the GPU the script
exits non-zero.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

import bench
from csdr_tpu.core.runtime import Pipeline
from csdr_tpu.models.symsync import sym_sync_c
from csdr_tpu.models import modem
from csdr_tpu.utils import firdes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--nsym", type=int, default=262144,
                    help="symbols per rep")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="write results JSON")
    args = ap.parse_args()
    bench.require_gpu()

    k, m = args.k, 3
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, args.nsym * 2)
    syms = modem.modulate(bits, "qpsk").astype(np.complex128)
    h = firdes.rrc(k, m, 0.5)
    up = np.zeros(args.nsym * k, dtype=np.complex128)
    up[::k] = syms
    x = np.convolve(up, h)[: args.nsym * k].astype(np.complex64)
    n = len(x)

    out = []
    for mode in ("block", "scan"):
        blk = sym_sync_c(m, k, 0.5, 32, mode=mode)
        pipe = Pipeline(blk, block_size=n, donate=False)
        xd = jax.device_put(x)
        y = pipe.process_block(xd)              # compile + warm
        jax.block_until_ready(y)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            y = pipe.process_block(xd)          # state carried step to step
        jax.block_until_ready((pipe.state, y))
        dt = (time.perf_counter() - t0) / args.reps
        r = {"mode": mode, "msps": n / dt / 1e6, "n": n, "k": k,
             "device": bench.device_info()}
        out.append(r)
        print(json.dumps(r))
    if len(out) == 2:
        print(json.dumps({"block_over_scan_speedup":
                          round(out[0]["msps"] / out[1]["msps"], 1)}))
    if args.out and out:
        with open(args.out, "w") as f:
            json.dump({"nsym": args.nsym, "k": args.k, "reps": args.reps,
                       "results": out, "device": bench.device_info()},
                      f, indent=1)
        print(f"# wrote {args.out}")


if __name__ == "__main__":
    main()
