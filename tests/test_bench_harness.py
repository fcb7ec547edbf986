"""Smoke tests for the benchmark harness pieces on the CPU: the virtual
scaling workers, the receiver validators, and the nodl streaming variant run
end-to-end so they cannot bit-rot between chip sessions."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmarks")


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.mark.parametrize("args", [
    ["single", "65536", "0.3", "-", "0"],
    ["single_nocomm", "65536", "0.3", "-", "0"],
    ["sharded", "2", "65536", "0.3"],
    ["sharded_resident", "2", "65536", "0.3"],
    ["sharded_nocomm", "2", "65536", "0.3"],
])
def test_scaling_worker_modes(args):
    p = subprocess.run([sys.executable,
                        os.path.join(BENCH, "scaling_worker.py")] + args,
                       capture_output=True, text=True, env=_cpu_env(),
                       timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stderr[-1500:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["msps"] > 0 and r["iters"] >= 1


def test_receiver_validators_run_on_cpu():
    """Two representative validators (cheap ones) run through the same code
    path the on-chip session uses."""
    sys.path.insert(0, BENCH)
    import validate_receivers as vr

    row = vr.val_rtty()
    assert row["ok"], row
    row = vr.val_pocsag()
    assert row["ok"], row


def test_streaming_nodl_cpu_mechanics():
    """The downlink-free variant's mechanics (host-truth byte count, one
    step per block, chained full-reduction checksum) on the CPU, which the
    script accepts only when told so explicitly."""
    env = _cpu_env()
    p = subprocess.run([sys.executable,
                        os.path.join(BENCH, "bench_streaming.py"),
                        str(1 << 23), "64", "cu8", "nodl", "allow-cpu"],
                       capture_output=True, text=True, env=env,
                       timeout=600, cwd=REPO)
    assert p.returncode == 0, p.stderr[-1500:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["metric"].endswith("cu8_nodl")
    assert r["value"] > 0
    assert "checksum" in r["sinks"]
    assert r["device"]["platform"] == "cpu"
