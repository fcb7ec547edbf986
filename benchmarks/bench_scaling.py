"""Multi-device scaling benchmark for the sharded channelized receiver.

On a host with several GPUs (four H100s over NVLink) this measures the
≥80% scaling-efficiency target (BASELINE.md) over 1, 2, 4 ... cards, each
timed window ending in `block_until_ready`.  `--virtual` runs the same
program on virtual CPU devices instead, which checks the sharded program end
to end but measures program structure, not a device.

Usage: python benchmarks/bench_scaling.py [max_devices] [--virtual]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    import bench

    args = [a for a in sys.argv[1:] if a != "--virtual"]
    want = int(args[0]) if args else 4
    if "--virtual" in sys.argv:
        jax.config.update("jax_num_cpu_devices", want)
        jax.config.update("jax_platforms", "cpu")
    else:
        bench.require_gpu()

    import jax.numpy as jnp
    from jax.sharding import Mesh
    from csdr_tpu.parallel.channelized import ShardedChannelizedFM

    nch = 64
    frames_per_dev = 4096
    results = []
    base = None
    nd = 1
    while nd <= min(want, len(jax.devices())):
        dc = 2 if nd % 2 == 0 and nd > 1 else 1
        dt_ = nd // dc
        mesh = Mesh(np.asarray(jax.devices()[:nd]).reshape(dt_, dc), ("time", "ch"))
        block = dt_ * nch * frames_per_dev
        sh = ShardedChannelizedFM(mesh=mesh, nch=nch, block_size=block)
        state = sh.init()
        x = jax.device_put(jnp.asarray(np.ones(block, np.complex64)), sh.input_sharding())
        state, y = sh.step(state, x)
        jax.block_until_ready(y)
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            state, y = sh.step(state, x)
        jax.block_until_ready(y)
        dt = time.perf_counter() - t0
        msps = iters * block / dt / 1e6
        if base is None:
            base = msps
        eff = msps / (base * nd)
        results.append(dict(devices=nd, mesh=[dt_, dc], msps=round(msps, 2),
                            scaling_efficiency=round(eff, 3)))
        nd *= 2

    print(json.dumps({
        "metric": "sharded_pfb64_fm_scaling",
        "device": bench.device_info(),
        "results": results,
    }))


if __name__ == "__main__":
    main()
