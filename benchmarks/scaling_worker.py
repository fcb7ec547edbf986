"""Worker for the virtual-scaling benchmark (bench_scaling_virtual.py).

Runs the flagship-style workload (DC blocker -> 16-ch PFB channelizer ->
per-channel FM demod, XLA path) on the CPU backend, either:

  single  <block> <secs> <sync_dir> <idx>   one device, serial Pipeline
  sharded <n> <block_per_dev> <secs>        n virtual CPU devices, ShardedChain

and prints one JSON line {"msps": ..., "iters": ..., "secs": ...}.

This is a virtual-CPU instrument by design: it measures the sharded
program's structure (halos, collectives, imbalance) against N independent
single-device workers, never a device speed.  CPU pinning is the PARENT's
job (taskset); the parent also runs this process with JAX_PLATFORMS=cpu,
and the worker refuses any other platform.

Synchronization for the aggregate-ceiling measurement: after warmup the
worker writes ``ready_<idx>`` into ``sync_dir`` and polls for ``go`` so all
N independent workers time the SAME wall-clock window (start skew would
otherwise overstate the ceiling).
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

NCH = 16


def _graph():
    from csdr_tpu.models.receivers import channelized_fm_receiver

    return channelized_fm_receiver(NCH, kf=0.6)


def _timed_loop(step_fn, secs: float):
    """Run step_fn repeatedly for ~secs of wall time; return (iters, dt)."""
    t0 = time.perf_counter()
    iters = 0
    while True:
        step_fn()
        iters += 1
        dt = time.perf_counter() - t0
        if dt >= secs:
            return iters, dt


def run_single(block: int, secs: float, sync_dir: str | None, idx: int):
    import numpy as np
    import jax
    from csdr_tpu.core.runtime import Pipeline

    graph = _graph()
    pipe = Pipeline(graph, block_size=block, donate=True)
    rng = np.random.default_rng(idx)
    x = (0.3 * np.exp(2j * np.pi * 0.21 * np.arange(block))
         + 0.02 * rng.normal(size=block)).astype(np.complex64)
    y = pipe.process_block(x)           # compile + warm
    jax.block_until_ready(y)
    y = pipe.process_block(x)
    jax.block_until_ready(y)

    if sync_dir:
        open(os.path.join(sync_dir, f"ready_{idx}"), "w").close()
        go = os.path.join(sync_dir, "go")
        while not os.path.exists(go):
            time.sleep(0.01)

    def step():
        jax.block_until_ready(pipe.process_block(x))

    iters, dt = _timed_loop(step, secs)
    print(json.dumps({"msps": round(iters * block / dt / 1e6, 2),
                      "iters": iters, "secs": round(dt, 3)}))


def run_sharded(n: int, block_per_dev: int, secs: float,
                resident: bool = False):
    """``resident=True`` pre-places the encoded input with the program's
    input sharding and reuses it, isolating the sharded program's structure
    (collectives/halos/imbalance) from the per-step host->device scatter —
    a cost that on N VIRTUAL devices is N+1 host memcpys of the same bytes
    and on a real slice is the NIC/PCIe feed measured separately by the
    streaming artifact."""
    import numpy as np
    import jax

    jax.config.update("jax_num_cpu_devices", n)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from csdr_tpu.parallel.generic import ShardedChain
    from csdr_tpu.core.runtime import CEnc, _encode_host

    graph = _graph()
    block = n * block_per_dev
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n, 1), ("time", "ch"))
    sh = ShardedChain(graph, mesh, block)
    rng = np.random.default_rng(0)
    x = (0.3 * np.exp(2j * np.pi * 0.21 * np.arange(block))
         + 0.02 * rng.normal(size=block)).astype(np.complex64)
    if resident:
        x = CEnc(jax.device_put(_encode_host(x).ri,
                                NamedSharding(mesh, P("time", None))))
    state = sh.init()
    state, y = sh.step(state, x)        # compile + warm
    jax.block_until_ready(y)
    state, y = sh.step(state, x)
    jax.block_until_ready(y)

    holder = {"state": state}

    def step():
        holder["state"], yy = sh.step(holder["state"], x)
        jax.block_until_ready(yy)

    iters, dt = _timed_loop(step, secs)
    print(json.dumps({"msps": round(iters * block / dt / 1e6, 2),
                      "iters": iters, "secs": round(dt, 3)}))


def run_single_scan(block: int, secs: float, sync_dir: str | None, idx: int,
                    k: int = 8):
    """Ceiling worker, scan-batched: one dispatch = lax.scan over k carried
    steps on a resident (k, block) input — the granularity a real deployment
    uses (double-buffered chunk uploads + on-device scan), applied to the
    SINGLE-device ceiling so the program/ceiling comparison stays symmetric."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    graph = _graph()
    rng = np.random.default_rng(idx)
    x = (0.3 * np.exp(2j * np.pi * 0.21 * np.arange(k * block))
         + 0.02 * rng.normal(size=k * block)).astype(np.complex64)
    X = jax.device_put(x.reshape(k, block))

    def scan_fn(state, xb):
        return graph.apply(state, xb)

    @jax.jit
    def steps(state, X):
        return jax.lax.scan(scan_fn, state, X)

    state = jax.jit(graph.init)()
    state, y = steps(state, X)
    jax.block_until_ready(y)
    state, y = steps(state, X)
    jax.block_until_ready(y)

    if sync_dir:
        open(os.path.join(sync_dir, f"ready_{idx}"), "w").close()
        go = os.path.join(sync_dir, "go")
        while not os.path.exists(go):
            time.sleep(0.01)
    holder = {"state": state}

    def step():
        holder["state"], yy = steps(holder["state"], X)
        jax.block_until_ready(yy)

    iters, dt = _timed_loop(step, secs)
    print(json.dumps({"msps": round(iters * k * block / dt / 1e6, 2),
                      "iters": iters, "secs": round(dt, 3)}))


def run_sharded_scan(n: int, block_per_dev: int, secs: float, k: int = 8):
    """Sharded program, scan-batched: the SAME k-step on-device scan, with
    the per-step collectives (halos, linrec gathers, channel psums) inside
    the scan body — one dispatch amortizes the multi-device launch overhead
    that dominated the per-dispatch protocol's raw efficiency."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_num_cpu_devices", n)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from csdr_tpu.parallel.generic import ShardedChain
    from csdr_tpu.core.runtime import CEnc, encode_tree, decode_tree

    graph = _graph()
    block = n * block_per_dev
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n, 1), ("time", "ch"))
    sh = ShardedChain(graph, mesh, block)  # reuse its validated shard_map
    rng = np.random.default_rng(0)
    x = (0.3 * np.exp(2j * np.pi * 0.21 * np.arange(k * block))
         + 0.02 * rng.normal(size=k * block)).astype(np.complex64)
    f = np.stack([x.real, x.imag], axis=-1).astype(np.float32).reshape(
        k, block, 2)
    X = CEnc(jax.device_put(f, NamedSharding(mesh, P(None, "time", None))))

    def scan_fn(state_enc, xb_enc):
        s, y = sh._shmap(decode_tree(state_enc), decode_tree(xb_enc))
        return encode_tree(s), encode_tree(y)

    @jax.jit
    def steps(state_enc, X_enc):
        return jax.lax.scan(scan_fn, state_enc, X_enc)

    state = sh.init()
    state, y = steps(state, X)
    jax.block_until_ready(y)
    state, y = steps(state, X)
    jax.block_until_ready(y)
    holder = {"state": state}

    def step():
        holder["state"], yy = steps(holder["state"], X)
        jax.block_until_ready(yy)

    iters, dt = _timed_loop(step, secs)
    print(json.dumps({"msps": round(iters * k * block / dt / 1e6, 2),
                      "iters": iters, "secs": round(dt, 3)}))


def _nocomm(x):
    """Collective-free elementwise workload (embarrassingly parallel): the
    control that isolates the in-process multi-device runtime's overhead
    from the sharded program's collectives."""
    import jax.numpy as jnp

    for _ in range(40):
        x = jnp.sin(x) * jnp.float32(1.001) + jnp.float32(0.1)
    return x


def run_single_nocomm(block: int, secs: float, sync_dir: str | None, idx: int):
    import numpy as np
    import jax

    f = jax.jit(_nocomm)
    x = jax.jit(lambda: jax.numpy.full((block,), 0.3 + 0.01 * idx,
                                       jax.numpy.float32))()
    y = f(x)
    jax.block_until_ready(y)
    if sync_dir:
        open(os.path.join(sync_dir, f"ready_{idx}"), "w").close()
        go = os.path.join(sync_dir, "go")
        while not os.path.exists(go):
            time.sleep(0.01)
    holder = {"y": y}

    def step():
        holder["y"] = f(holder["y"])
        jax.block_until_ready(holder["y"])

    iters, dt = _timed_loop(step, secs)
    print(json.dumps({"msps": round(iters * block / dt / 1e6, 2),
                      "iters": iters, "secs": round(dt, 3)}))


def run_sharded_nocomm(n: int, block_per_dev: int, secs: float):
    import numpy as np
    import jax

    jax.config.update("jax_num_cpu_devices", n)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    block = n * block_per_dev
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("t",))
    x = jax.device_put(np.full((block,), 0.3, np.float32),
                       NamedSharding(mesh, P("t")))
    f = jax.jit(jax.shard_map(_nocomm, mesh=mesh, in_specs=P("t"),
                              out_specs=P("t")))
    y = f(x)
    jax.block_until_ready(y)
    holder = {"y": y}

    def step():
        holder["y"] = f(holder["y"])
        jax.block_until_ready(holder["y"])

    iters, dt = _timed_loop(step, secs)
    print(json.dumps({"msps": round(iters * block / dt / 1e6, 2),
                      "iters": iters, "secs": round(dt, 3)}))


def main():
    # checked without touching JAX: the sharded modes still have to set the
    # virtual device count before the backend starts
    if os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit("scaling_worker runs on virtual CPU devices only "
                         "(set JAX_PLATFORMS=cpu)")
    mode = sys.argv[1]
    if mode in ("single", "single_nocomm", "single_scan"):
        block = int(sys.argv[2])
        secs = float(sys.argv[3])
        sync_dir = sys.argv[4] if len(sys.argv) > 4 and sys.argv[4] != "-" else None
        idx = int(sys.argv[5]) if len(sys.argv) > 5 else 0
        if mode == "single_scan":
            k = int(sys.argv[6]) if len(sys.argv) > 6 else 8
            run_single_scan(block, secs, sync_dir, idx, k=k)
        else:
            (run_single if mode == "single" else run_single_nocomm)(
                block, secs, sync_dir, idx)
    elif mode == "sharded":
        run_sharded(int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4]))
    elif mode == "sharded_resident":
        run_sharded(int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4]),
                    resident=True)
    elif mode == "sharded_nocomm":
        run_sharded_nocomm(int(sys.argv[2]), int(sys.argv[3]),
                           float(sys.argv[4]))
    elif mode == "sharded_scan":
        k = int(sys.argv[5]) if len(sys.argv) > 5 else 8
        run_sharded_scan(int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4]),
                         k=k)
    else:
        raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    main()
