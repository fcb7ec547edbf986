#!/bin/sh
# ex13: the flagship config — 64-channel PFB channelizer + per-channel FM
# demod — on a 2x1 device mesh.  --mesh TxC on the channelized FM flow runs
# the hand-sharded XLA receiver (parallel/channelized.ShardedChannelizedFM):
# time segments per device with ppermute halos, the DC blocker's carry
# reconstructed in closed form, the DFT sharded over the channel axis.
# Run on the CPU mesh (tests/conftest pattern); drop the env overrides to
# run on real devices (e.g. `--mesh 4x1` on four GPUs).
set -e
cd "$(dirname "$0")/.."
export JAX_PLATFORMS=cpu
export XLA_FLAGS="--xla_force_host_platform_device_count=2 ${XLA_FLAGS}"

python - <<'PY'
# synthesize a 64-carrier multiplex: one FM tone per channel
import sys
sys.path.insert(0, ".")
import numpy as np

nch = 64
n = 1 << 18
t = np.arange(n)
rng = np.random.default_rng(5)
x = np.zeros(n, np.complex128)
for ch in (3, 17, 40, 63):   # four active stations
    fc = (ch / nch + 0.5 / nch) % 1.0 - 0.5
    msg = np.sin(2 * np.pi * 0.001 * (ch + 1) * t)
    x += 0.2 * np.exp(2j * np.pi * (fc * t + 0.05 * np.cumsum(msg) / nch))
x += 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
x.astype(np.complex64).tofile("/tmp/ex13_mux.cf32")
print(f"wrote /tmp/ex13_mux.cf32 ({n} samples, {nch} channels)")
PY

python -m csdr_tpu.apps.soapy_sdr_cli \
  --filename /tmp/ex13_mux.cf32 -s 2.56e6 -n $((1 << 18)) -c 64 \
  --demod "DeNBFM 0.6 WAV" --mesh 2x1 --blocksize $((1 << 16)) \
  -o /tmp/ex13_audio

echo "--- per-channel WAVs ---"
ls /tmp/ex13_audio_ch*.wav | head -4
echo "... (64 files, one per channel)"
