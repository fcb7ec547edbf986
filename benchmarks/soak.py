"""Long-running soak: config-5 workload + periodic checkpoints + kill/resume.

Wires the sharded pipeline, periodic checkpointing and mid-soak
SIGKILL/resume into an automated soak that verifies exact sample
accounting.  The reference's only integrity evidence is a byte-count
invariant eyeballed after a run (/root/reference/README.md:191-192); this
soak verifies, per cycle, (a) the exact output byte count and (b) BIT
IDENTITY of the killed+resumed run against an uninterrupted golden run.

Orchestrated mode (the default) repeats for --duration seconds:
  1. run a worker subprocess processing N samples of a seeded synthetic
     64-channel multiplex through ShardedChain(dcBlocker → PFB(64) →
     per-channel FM demod) with checkpoints every --ckpt samples;
  2. SIGKILL it at a random moment mid-run;
  3. relaunch with --resume: the worker restores the checkpoint, seeks the
     source with skip_n, truncates the partial output to the checkpoint
     position, and finishes;
  4. compare sha256 + size against the golden run.

    python benchmarks/soak.py --duration 3600 --log soak.log

Worker mode (internal): python benchmarks/soak.py --worker [--resume] ...

The workers run on --devices virtual CPU devices: the soak checks
checkpoint/resume exactness of the sharded program, not a device's speed.
The orchestrating parent never imports JAX, so it holds no device while its
workers run.
"""

import argparse
import hashlib
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

NCH = 64
BLOCK_FRAMES = 512  # frames/device/step


def synth_source(total: int, chunk: int = 1 << 20):
    """Deterministic multi-tone + per-chunk seeded noise (position-seeded so
    a resumed run regenerates identical samples after skip_n)."""
    pos = 0
    while pos < total:
        n = min(chunk, total - pos)
        t = np.arange(pos, pos + n, dtype=np.float64)
        x = np.zeros(n, dtype=np.complex128)
        for i, f in enumerate((-0.37, -0.11, 0.05, 0.23, 0.41)):
            x += (0.4 / (i + 1)) * np.exp(2j * np.pi * np.mod(f * t, 1.0))
        rng = np.random.default_rng(1234 + pos)  # chunk-position seeded
        x += 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
        yield x.astype(np.complex64)
        pos += n


def build(n_devices: int):
    # virtual CPU mesh, selected before any device query
    import jax

    jax.config.update("jax_num_cpu_devices", n_devices)
    jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh
    import csdr_tpu as cs
    from csdr_tpu.parallel.generic import ShardedChain

    devs = jax.devices()[:n_devices]
    dc = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = Mesh(np.asarray(devs).reshape(n_devices // dc, dc), ("time", "ch"))
    graph = cs.chain(cs.dc_blocker(), cs.firpfbch_channelizer(NCH),
                     cs.PerChannel(cs.fm_demodulator(0.6), NCH))
    block = (n_devices // dc) * NCH * BLOCK_FRAMES
    return ShardedChain(graph, mesh, block)


def worker(args) -> int:
    from csdr_tpu.core.runtime import rechunk, decode_tree_host, skip_n
    from csdr_tpu.core.checkpoint import save_state, load_state

    sh = build(args.devices)
    state = sh.init()
    consumed = 0
    mode = "wb"
    if args.resume and os.path.exists(args.ckpt_path):
        state, consumed = load_state(args.ckpt_path, state, signature="soak64")
        # truncate partial output back to the checkpoint position
        out_bytes = consumed * 4  # rate 1/64 × 64 channels × f32
        with open(args.out, "ab") as f:
            f.truncate(out_bytes)
        mode = "ab"
        print(json.dumps({"ev": "resumed", "position": consumed}), flush=True)
    src = skip_n(synth_source(args.total), consumed) if consumed else \
        synth_source(args.total)
    last_ck = consumed
    with open(args.out, mode) as f:
        for chunk in rechunk(src, sh.block_size):
            state, y = sh.step(state, chunk)
            arr = decode_tree_host(y)           # (nch, F)
            arr.astype(np.float32).T.tofile(f)  # frame-major for determinism
            consumed += sh.block_size
            if consumed - last_ck >= args.ckpt:
                f.flush()
                save_state(args.ckpt_path, state, position=consumed,
                           signature="soak64")
                last_ck = consumed
                print(json.dumps({"ev": "ckpt", "position": consumed}),
                      flush=True)
    print(json.dumps({"ev": "done", "consumed": consumed}), flush=True)
    return 0


def orchestrate(args) -> int:
    logf = open(args.log, "a") if args.log else sys.stdout

    def log(**kw):
        kw["t"] = round(time.time() - t_start, 1)
        print(json.dumps(kw), file=logf, flush=True)

    t_start = time.time()
    tmp = args.workdir
    os.makedirs(tmp, exist_ok=True)
    golden = os.path.join(tmp, "golden.f32")
    wout = os.path.join(tmp, "soak_out.f32")
    ckpt = os.path.join(tmp, "soak_ckpt.npz")
    base_cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                "--total", str(args.total), "--devices", str(args.devices),
                "--ckpt", str(args.ckpt), "--ckpt-path", ckpt]
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")

    # golden uninterrupted run
    log(ev="golden_start", total=args.total)
    rc = subprocess.call(base_cmd + ["--out", golden], env=env,
                         stdout=subprocess.DEVNULL)
    assert rc == 0, "golden run failed"
    want_hash = hashlib.sha256(open(golden, "rb").read()).hexdigest()
    want_size = os.path.getsize(golden)
    assert want_size == args.total * 4, (want_size, args.total * 4)
    log(ev="golden_done", sha256=want_hash[:16], bytes=want_size)

    cycles = ok = 0
    rng = random.Random(7)
    while time.time() - t_start < args.duration:
        cycles += 1
        for p in (wout, ckpt):
            if os.path.exists(p):
                os.remove(p)
        # start worker, SIGKILL it mid-run
        proc = subprocess.Popen(base_cmd + ["--out", wout], env=env,
                                stdout=subprocess.DEVNULL)
        kill_after = rng.uniform(0.25, 0.75) * args.cycle_estimate
        time.sleep(kill_after)
        if proc.poll() is None:
            proc.kill()   # exact PID, SIGKILL — no graceful shutdown
            proc.wait()
            killed = True
        else:
            killed = False
        had_ckpt = os.path.exists(ckpt)
        # resume and finish
        rc = subprocess.call(base_cmd + ["--out", wout, "--resume"], env=env,
                             stdout=subprocess.DEVNULL)
        got = hashlib.sha256(open(wout, "rb").read()).hexdigest()
        size_ok = os.path.getsize(wout) == want_size
        identical = got == want_hash
        ok += bool(rc == 0 and size_ok and identical)
        log(ev="cycle", n=cycles, killed=killed, resumed_from_ckpt=had_ckpt,
            kill_after_s=round(kill_after, 1), exact_bytes=size_ok,
            bit_identical=identical)
    log(ev="soak_done", cycles=cycles, passed=ok,
        wall_s=round(time.time() - t_start, 1))
    return 0 if ok == cycles and cycles > 0 else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--total", type=int, default=64 * 1024 * 1024)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--ckpt", type=int, default=8 * 1024 * 1024)
    tmp = tempfile.gettempdir()
    ap.add_argument("--ckpt-path", default=os.path.join(tmp, "soak_ckpt.npz"))
    ap.add_argument("--out", default=os.path.join(tmp, "soak_out.f32"))
    ap.add_argument("--duration", type=float, default=3600.0)
    ap.add_argument("--cycle-estimate", type=float, default=60.0,
                    help="rough seconds per full run (sets kill timing)")
    ap.add_argument("--workdir", default=os.path.join(tmp, "csdr_soak"))
    ap.add_argument("--log", default=None)
    args = ap.parse_args()
    if args.worker:
        sys.exit(worker(args))
    sys.exit(orchestrate(args))


if __name__ == "__main__":
    main()
