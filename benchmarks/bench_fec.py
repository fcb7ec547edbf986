"""Throughput of the vectorized-trellis Viterbi (ops/fec.py).

The decoder's ACS recursion is a lax.scan whose per-step work is one
(2, S) gather + add + max across all 2^(K-1) states; per-packet work is
sequential in symbols, so device throughput comes from BATCH parallelism —
`jax.vmap` over packets turns the trellis into (B, 2, S) panels.  This
measures decoded Mbit/s for K=7 rate-1/2 at several batch sizes: iteration
i+1 consumes iteration i's output (the LLRs are nudged by the previous
decode), and every timed window ends in `block_until_ready`.

Usage: python benchmarks/bench_fec.py [--msg-bits N] [--reps N] [--iters N]

Off the GPU the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--msg-bits", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp

    import bench
    from csdr_tpu.ops import fec

    bench.require_gpu()
    rng = np.random.default_rng(0)
    rows = []
    for batch in (1, 8, 64, 256):
        msgs = rng.integers(0, 2, (batch, args.msg_bits))
        llr0 = np.stack([1.0 - 2.0 * fec.conv_encode(m) for m in msgs]
                        ).astype(np.float32)
        dec1 = jax.vmap(lambda v: fec.viterbi_decode(v))

        @jax.jit
        def step(llr):
            bits = dec1(llr)
            tweak = (bits[:, :1].astype(jnp.float32) - 0.5) * 1e-3
            return llr + tweak, bits

        llr, bits = step(jnp.asarray(llr0))     # compile + warm
        jax.block_until_ready(bits)
        vals = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                llr, bits = step(llr)
            jax.block_until_ready((llr, bits))
            dt = (time.perf_counter() - t0) / args.iters
            vals.append(batch * args.msg_bits / dt / 1e6)
        vals.sort()
        med = vals[len(vals) // 2]
        rows.append({"batch": batch, "msg_bits": args.msg_bits,
                     "decoded_Mbps": med, "reps": args.reps})
        print(f"# batch {batch:4d}: {med:10.2f} Mbit/s decoded", flush=True)

    print(json.dumps({"metric": "viterbi_decoded_Mbps", "K": 7,
                      "rate": "1/2", "rows": rows,
                      "device": bench.device_info()}))


if __name__ == "__main__":
    main()
