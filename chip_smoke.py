"""Prove the served DSP path on an NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below but `mesh`
    python chip_smoke.py --multi    # four cards: the `mesh` phase only

Phases, all in this one process (one JAX client per card):

  timing    the XLA flagship step (64 channels, 2^23-sample blocks, cf32 and
            cu8, state carried) with MSPS, compile seconds,
            `memory_analysis()` and `peak_bytes_in_use` (bench.flagship_step);
  tests     the tests marked `gpu`, in-process;
  flagship  BASELINE config 5 on one card: a seeded 2^25-sample capture with
            FM carriers in 8 of 64 channels, written as cf32 and as cu8 and
            run through `soapy_sdr_cli.main`; every signal channel's WAV
            must be within SNR_FLOOR_DB of the float64 reference
            (csdr_tpu.utils.reference);
  wbfm      BASELINE config 1: msresamp → WBFM → WAV through the CLI, against
            the de-emphasized message (WBFM_FLOOR_DB);
  mesh      the 64-channel flow under `--mesh 4x1` and `--mesh 2x2`, each
            compared with the one-card output and the float64 reference,
            with its blocks checked to land on four devices.

The card's name and power limit (nvidia-smi) and the JAX device come first.
The last line is `{"ok": true, "device": {...}}` only when every phase
passed; off the GPU, or when any phase fails, the script exits non-zero
without it.

Tolerances.  Matmuls run at jax_default_matmul_precision="highest" (set by
csdr_tpu), so no TF32.  At that precision float32 agrees with float64 to
about 130 dB per signal channel (measured on the CPU); a TF32 DFT would land
near 65 dB.  SNR_FLOOR_DB = 80 sits between the two, with room for the
last-bit differences that XLA's per-process choice of GPU algorithms may
give.  Channels carrying only noise are reported, not gated: the FM
discriminator of noise wraps its phase at ±π, where a last-bit difference
moves a sample by a full cycle.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

import bench
from csdr_tpu.utils import reference as R
from csdr_tpu.utils import testsig

NCH = 64
KF = 0.6
FS = 2.56e6
N_SAMPLES = 1 << 25
BLOCK = 1 << 23
SEED = 1234
SNR_FLOOR_DB = 80.0
# The WBFM oracle (resample_poly, butterworth de-emphasis, resample_poly
# decimation) differs from the chain's kaiser designs near the message band;
# they agree to ~41 dB at 2^23 samples on the CPU and the card alike, and a
# broken chain reads far below.  The floor leaves 5 dB for the oracle.
WBFM_FLOOR_DB = 36.0
MESH_SHAPES = ("4x1", "2x2")
PHASES = ("timing", "tests", "flagship", "wbfm")
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def write_capture(workdir: str, wire: str, n: int, nch: int, seed: int):
    """Seeded capture as a file the CLI reads → (path, complex128 input the
    reference sees, signal channels)."""
    iq, k_sig = testsig.fm_channel_capture(n, nch, seed=seed, kf=KF)
    if wire == "cu8":
        u8 = testsig.to_cu8(iq)
        path = os.path.join(workdir, f"cap_{seed}.cu8")
        u8.tofile(path)
        return path, R.cu8_to_iq(u8), k_sig
    path = os.path.join(workdir, f"cap_{seed}.cf32")
    iq.tofile(path)
    return path, iq.astype(np.complex128), k_sig


def run_cli_channels(path: str, out: str, n: int, nch: int, block: int,
                     mesh: str | None = None) -> np.ndarray:
    """The 64-channel FM flow through the CLI entry point → (nch, n/nch)."""
    from csdr_tpu.apps import soapy_sdr_cli
    from csdr_tpu.io import wav as wavio

    argv = ["--filename", path, "-s", str(FS), "-n", str(n),
            "-c", str(nch), "--demod", f"DeNBFM {KF} WAV",
            "--blocksize", str(block), "--chunksize", str(1 << 20),
            "-o", out]
    if mesh:
        argv += ["--mesh", mesh]
    rc = soapy_sdr_cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"soapy_sdr_cli.main returned {rc}")
    return np.stack([wavio.read_wav(f"{out}_ch{k + 1}.wav")[0]
                     for k in range(nch)])


def check_channels(label: str, got: np.ndarray, want: np.ndarray,
                   k_sig: list[int]) -> dict:
    """Gate every signal channel at SNR_FLOOR_DB against ``want``."""
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{label}: shape {got.shape} vs {want.shape}, "
                             f"finite={bool(np.all(np.isfinite(got)))}")
    snr = R.channel_snr_db(want, got)
    noise = np.delete(snr, k_sig)
    r = {"min_signal_snr_db": float(np.min(snr[k_sig])),
         "signal_snr_db": [round(float(s), 2) for s in snr[k_sig]],
         "noise_snr_db_min": float(np.min(noise)) if noise.size else None,
         "noise_snr_db_median": float(np.median(noise)) if noise.size else None}
    log(f"{label}: {json.dumps(r)}")
    if r["min_signal_snr_db"] < SNR_FLOOR_DB:
        raise AssertionError(f"{label}: signal channel SNR "
                             f"{r['min_signal_snr_db']:.2f} dB < "
                             f"{SNR_FLOOR_DB} dB")
    return r


def phase_flagship(workdir: str, wire: str, n: int = N_SAMPLES,
                   nch: int = NCH, block: int = BLOCK,
                   seed: int = SEED) -> dict:
    path, ref_in, k_sig = write_capture(workdir, wire, n, nch, seed)
    t0 = time.perf_counter()
    got = run_cli_channels(path, os.path.join(workdir, f"fm_{wire}"),
                           n, nch, block)
    wall = time.perf_counter() - t0
    r = check_channels(f"flagship {wire} vs float64", got,
                       R.flagship_reference(ref_in, nch, KF), k_sig)
    r.update(wire=wire, samples=n, cli_wall_s=wall)
    return r


def wbfm_capture(n: int, seed: int, fs: float = FS, bw: float = 200e3):
    """BASELINE config 1 input: a 3 kHz band-limited message at the 200 kHz
    quad rate, FM-modulated at the capture rate → (iq, message at bw)."""
    from scipy.signal import firwin, lfilter, resample_poly

    rng = np.random.default_rng(seed)
    up, down = 64, 5                     # 200 kHz → 2.56 MHz
    assert fs * down == bw * up
    msg = lfilter(firwin(301, 2 * 3000.0 / bw), [1.0],
                  rng.normal(size=n * down // up + 1))
    # fixed rms (not peak) level, so the SNR does not drift with length
    msg *= 0.08 / np.std(msg)
    msg_fs = resample_poly(msg, up, down)[:n].astype(np.float32)
    return testsig.fm_mod(msg_fs, KF * down / up), msg


def phase_wbfm(workdir: str, n: int = 1 << 23, block: int = 1 << 20,
               seed: int = SEED) -> dict:
    from scipy.signal import butter, lfilter, resample_poly

    from csdr_tpu.apps import soapy_sdr_cli
    from csdr_tpu.io import wav as wavio

    bw, decim = 200e3, 8
    iq, msg = wbfm_capture(n, seed)
    path = os.path.join(workdir, "wbfm.cf32")
    iq.tofile(path)
    ns = n * 5 // 64
    out = os.path.join(workdir, "wbfm")
    rc = soapy_sdr_cli.main(["--filename", path, "-s", str(FS), "-b", str(bw),
                             "-n", str(ns), "--demod", f"DeWBFM {decim} WAV",
                             "-o", out, "--blocksize", str(block),
                             "--chunksize", str(1 << 20)])
    if rc != 0:
        raise RuntimeError(f"soapy_sdr_cli.main returned {rc}")
    audio, sr = wavio.read_wav(out + ".wav")
    if sr != int(bw) // decim or len(audio) != ns // decim:
        raise AssertionError(f"wbfm: {len(audio)} samples at {sr} Hz")
    bd, ad = butter(2, 2 * 5000.0 / bw)
    want = resample_poly(lfilter(bd, ad, msg), 1, decim)[: len(audio)]
    snr = testsig.snr_db(want[500:-500], audio[500:-500])
    r = {"snr_db": snr, "samples": n, "audio_samples": len(audio)}
    log(f"wbfm vs de-emphasized message: {json.dumps(r)}")
    if not snr > WBFM_FLOOR_DB:
        raise AssertionError(f"wbfm: SNR {snr:.2f} dB <= {WBFM_FLOOR_DB} dB")
    return r


def phase_timing(block: int = BLOCK, iters: int = 200) -> dict:
    out = {}
    for wire in ("cf32", "cu8"):
        r = bench.flagship_step(wire, block, iters)
        log(f"timing {wire}: {json.dumps(r)}")
        out[wire] = r
    return out


def phase_tests() -> dict:
    """The `gpu`-marked tests, in this process (a child would be a second
    JAX client on the card)."""
    import pytest

    os.environ["CSDR_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(REPO, "tests")])
    log(f"gpu tests: pytest exit {int(rc)}")
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest exit {int(rc)})")
    return {"pytest_exit": int(rc)}


def mesh_devices(mesh_shape: str, nch: int, block: int) -> tuple[int, int]:
    """Devices holding one input block and one output block of the sharded
    flow the CLI builds for `--mesh mesh_shape`."""
    import jax
    from jax.sharding import Mesh

    from csdr_tpu.parallel.channelized import ShardedChannelizedFM
    from csdr_tpu.parallel.runner import ShardedPipeline

    dt, dc = (int(v) for v in mesh_shape.split("x"))
    mesh = Mesh(np.asarray(jax.devices()[:dt * dc]).reshape(dt, dc),
                ("time", "ch"))
    blk = max(block // (dt * nch), 64) * dt * nch
    sh = ShardedChannelizedFM(mesh=mesh, nch=nch, block_size=blk, kf=KF)
    runner = ShardedPipeline(sh)
    x = runner._put(np.ones(blk, np.complex64))
    _, y = sh.step(runner.state, x)
    return len(x.ri.sharding.device_set), len(y.sharding.device_set)


def phase_mesh(workdir: str, n: int = N_SAMPLES, nch: int = NCH,
               block: int = BLOCK, seed: int = SEED,
               shapes: tuple = MESH_SHAPES) -> dict:
    path, ref_in, k_sig = write_capture(workdir, "cf32", n, nch, seed)
    want = R.flagship_reference(ref_in, nch, KF)
    one = run_cli_channels(path, os.path.join(workdir, "one"), n, nch, block)
    out = {"one_card": check_channels("one card vs float64", one, want, k_sig)}
    for shape in shapes:
        ndev = int(np.prod([int(v) for v in shape.split("x")]))
        n_in, n_out = mesh_devices(shape, nch, block)
        log(f"mesh {shape}: input block on {n_in} devices, "
            f"output on {n_out}")
        if n_in != ndev or n_out != ndev:
            raise AssertionError(f"mesh {shape}: blocks on {n_in}/{n_out} "
                                 f"devices, want {ndev}")
        got = run_cli_channels(path, os.path.join(workdir, f"m{shape}"),
                               n, nch, block, mesh=shape)
        out[shape] = {
            "vs_one_card": check_channels(f"mesh {shape} vs one card",
                                          got, one, k_sig),
            "vs_float64": check_channels(f"mesh {shape} vs float64",
                                         got, want, k_sig),
            "devices": n_in,
        }
    return out


def plan(argv=None) -> tuple[argparse.Namespace, list[str]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)
    return args, (["mesh"] if args.multi else list(PHASES))


def main(argv=None) -> int:
    args, phases = plan(argv)
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: no GPU (JAX's default backend is {backend!r})",
              file=sys.stderr)
        return 1
    for ln in bench.nvidia_smi_lines():
        log(ln)
    dev = bench.device_info()
    log(f"device: {dev['platform']} {dev['kind']} x{dev['count']}")
    log(f"matmul precision: {jax.config.jax_default_matmul_precision}")
    from csdr_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    if args.multi and dev["count"] < 4:
        print(f"chip_smoke: --multi needs 4 devices, have {dev['count']}",
              file=sys.stderr)
        return 1

    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        for name in phases:
            t0 = time.perf_counter()
            log(f"== phase {name}")
            try:
                if name == "timing":
                    phase_timing()
                elif name == "tests":
                    phase_tests()
                elif name == "flagship":
                    for wire in ("cf32", "cu8"):
                        phase_flagship(workdir, wire)
                elif name == "wbfm":
                    phase_wbfm(workdir)
                elif name == "mesh":
                    phase_mesh(workdir)
            except Exception as e:  # report every phase, fail at the end
                import traceback

                traceback.print_exc()
                failed.append(f"{name}: {type(e).__name__}: {e}")
            log(f"== phase {name}: {time.perf_counter() - t0:.1f} s")
    if failed:
        for f in failed:
            print(f"FAILED {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
