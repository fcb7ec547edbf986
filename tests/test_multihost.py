"""TRUE multi-process execution of the generic sharded runtime.

The rest of the suite shards over a single-process virtual mesh; this test
runs ShardedChain across TWO OS processes joined by jax.distributed (Gloo
CPU collectives) — the actual multi-host mechanism a multi-host GPU job uses
(SURVEY.md §4: "multi-host tests runnable on CPU via jax.distributed"), so
the cross-process collective path (psum/ppermute over a global mesh, global
array inputs, replicated carried state) is exercised for real, not emulated.

Each worker owns 2 virtual CPU devices → a 4-device global (time, ch) mesh.
Both workers generate the same capture, encode their local time segment,
assemble a global CEnc input, and stream 3 consecutive blocks through
chain(dc_blocker, fm_demodulator, fir_decimator(4)); every process then
checks its ADDRESSABLE output shards bit-exactly against a locally-computed
serial Pipeline reference (carried state must stay exact across blocks on
the distributed mesh)."""

import os
import socket
import subprocess
import sys

import numpy as np

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.environ["CSDR_REPO"])
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                           process_id=pid)
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental import multihost_utils

import csdr_tpu as cs
from csdr_tpu.core.runtime import CEnc, Pipeline, decode_tree_host
from csdr_tpu.parallel import ShardedChain

assert jax.device_count() == 4 and jax.local_device_count() == 2

graph = cs.chain(cs.dc_blocker(), cs.fm_demodulator(0.6), cs.fir_decimator(4))
block = 1 << 14
nblocks = 3
rng = np.random.default_rng(7)  # identical capture on every process
n = block * nblocks
msg = np.cumsum(0.3 * np.sin(2 * np.pi * 0.002 * np.arange(n)))
iq = (np.exp(1j * 2 * np.pi * 0.2 * msg)
      + 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
      ).astype(np.complex64)

# serial reference, computed locally by every process
ref_pipe = Pipeline(graph, block_size=block)
refs = [decode_tree_host(ref_pipe.process_block(iq[b*block:(b+1)*block]))
        for b in range(nblocks)]

mesh = Mesh(np.array(jax.devices()).reshape(4, 1), ("time", "ch"))
sc = ShardedChain(graph, mesh, block)
state = sc.init()
nloc = block // 4
nloc_out = sc.nloc_out
for b in range(nblocks):
    xb = iq[b*block:(b+1)*block]
    # encode host-side, then assemble the global CEnc from each process's
    # LOCAL time segment — the real multi-host input path (no process ever
    # holds the full device array)
    planes = np.stack([xb.real, xb.imag], axis=-1).astype(np.float32)
    local = planes[pid * (block // nproc):(pid + 1) * (block // nproc)]
    g = multihost_utils.host_local_array_to_global_array(
        local, mesh, P("time", None))
    state, y = sc.step(state, CEnc(g))
    plane = y.ri if isinstance(y, CEnc) else y
    want = refs[b]
    for shard in plane.addressable_shards:
        sl = shard.index[0]
        got = np.asarray(shard.data)
        if isinstance(y, CEnc):
            got = (got[..., 0] + 1j * got[..., 1]).astype(np.complex64)
        err = np.max(np.abs(got - want[sl]))
        assert err < 1e-6, (pid, b, sl, err)
print(f"[{pid}] OK: {nblocks} blocks bit-exact on the 2-process mesh", flush=True)

# second scenario: channelizer on a (time=2, ch=2) mesh — the channel-sharded
# DFT/psum path crosses the process boundary too
nch = 8
gr2 = cs.chain(cs.dc_blocker(), cs.firpfbch_channelizer(nch))
mesh2 = Mesh(np.array(jax.devices()).reshape(2, 2), ("time", "ch"))
sc2 = ShardedChain(gr2, mesh2, block)
ref2 = Pipeline(gr2, block_size=block)
state2 = sc2.init()
for b in range(2):
    xb = iq[b*block:(b+1)*block]
    want = decode_tree_host(ref2.process_block(xb))
    planes = np.stack([xb.real, xb.imag], axis=-1).astype(np.float32)
    local = planes[pid * (block // nproc):(pid + 1) * (block // nproc)]
    g = multihost_utils.host_local_array_to_global_array(
        local, mesh2, P("time", None))
    state2, y = sc2.step(state2, CEnc(g))
    plane = y.ri
    for shard in plane.addressable_shards:
        ch_sl, t_sl = shard.index[0], shard.index[1]
        got = np.asarray(shard.data)
        got = (got[..., 0] + 1j * got[..., 1]).astype(np.complex64)
        err = np.max(np.abs(got - want[ch_sl, t_sl]))
        assert err < 1e-5, (pid, b, ch_sl, t_sl, err)
print(f"[{pid}] OK: channelizer bit-exact on the (2,2) 2-process mesh", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_sharded_chain_across_two_processes(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["CSDR_REPO"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert "OK: 3 blocks bit-exact" in out, out[-2000:]
        assert "OK: channelizer bit-exact" in out, out[-2000:]
