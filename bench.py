"""Time the XLA flagship step on the GPU.

The flagship graph is BASELINE.json config 5 on one card: dc_blocker → NCO
pre-shift → 64-channel polyphase filterbank → per-channel FM demod
(`models.receivers.channelized_fm_receiver`), run through the Pipeline's
jitted step with its state carried from step to step.  Input is made on the
device from a seed, as cf32 planes or as interleaved cu8 bytes (then the
graph starts with `u8_to_iq`).  Each timed window ends in
`block_until_ready`.

    python bench.py [--wire cf32|cu8] [--block N] [--iters N]

Prints the card (name and power limit from nvidia-smi), the JAX device and
count, then one JSON line.  Exits non-zero when JAX's backend is not a GPU.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time

NCH = 64
KF = 0.6
BLOCK = 1 << 23


def nvidia_smi_lines() -> list[str]:
    """The card(s) as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints them, one line per card.  Raises
    RuntimeError when nvidia-smi is missing or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    p = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=30)
    if p.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {p.stderr.strip()}")
    return parse_nvidia_smi(p.stdout)


def parse_nvidia_smi(text: str) -> list[str]:
    """Split nvidia-smi's csv output into one "name, power.limit" line per
    card; raises ValueError on output that is not two fields a line."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("nvidia-smi printed no card")
    for ln in lines:
        if len(ln.split(",")) != 2:
            raise ValueError(f"unexpected nvidia-smi line {ln!r}")
    return lines


def device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> None:
    """Exit non-zero unless JAX's default backend is a GPU: a number from
    any other device is not a measurement of the card."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"no GPU: JAX's default backend is {backend!r}")


def flagship_step(wire: str = "cf32", block: int = BLOCK, iters: int = 50,
                  nch: int = NCH, kf: float = KF, seed: int = 0) -> dict:
    """Compile and time the flagship Pipeline step on `block` complex input
    samples per step.  Returns MSPS (input samples), compile seconds,
    `compiled.memory_analysis()` fields and the device's
    `peak_bytes_in_use` (None where the backend keeps no such count)."""
    import jax
    import jax.numpy as jnp

    import csdr_tpu as cs
    from csdr_tpu.core.runtime import CEnc, Pipeline
    from csdr_tpu.models.receivers import channelized_fm_receiver

    graph = channelized_fm_receiver(nch, kf=kf)
    key = jax.random.PRNGKey(seed)
    if wire == "cu8":
        graph = cs.chain(cs.u8_to_iq(), graph)
        x = jax.jit(lambda k: jax.random.randint(
            k, (2 * block,), 0, 256, jnp.int32).astype(jnp.uint8))(key)
        pipe = Pipeline(graph, block_size=2 * block)
    elif wire == "cf32":
        x = CEnc(jax.jit(lambda k: 0.3 * jax.random.normal(
            k, (block, 2), jnp.float32))(key))
        pipe = Pipeline(graph, block_size=block)
    else:
        raise ValueError(f"wire must be cf32 or cu8, got {wire!r}")

    state = pipe.state
    t0 = time.perf_counter()
    compiled = pipe._step.lower(state, x).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    memory = {k: getattr(mem, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(mem, k)}

    state, y = compiled(state, x)           # warm-up step
    jax.block_until_ready((state, y))
    t0 = time.perf_counter()
    for _ in range(iters):
        state, y = compiled(state, x)
    jax.block_until_ready((state, y))
    dt = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "wire": wire, "nch": nch, "block": block, "iters": iters,
        "step_s": dt / iters, "msps": iters * block / dt / 1e6,
        "compile_s": compile_s, "memory_analysis": memory,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wire", choices=("cf32", "cu8"), default="cf32")
    ap.add_argument("--block", type=int, default=BLOCK)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)

    require_gpu()
    from csdr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cards = nvidia_smi_lines()
    for ln in cards:
        print(ln)
    dev = device_info()
    print(f"device: {dev['platform']} {dev['kind']} x{dev['count']}")
    r = flagship_step(args.wire, args.block, args.iters)
    r.update(metric="flagship64_step_throughput", unit="Msamples/s",
             device=dev, card=cards[0])
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
