#!/bin/sh
# ex12: stereo FM + RDS decode on a 2x1 device mesh — the multi-rate Tee
# (stereo audio at 1/4 rate, RDS bits at 19/3840) sharded over time with
# per-branch output specs; output is byte-identical to the serial run.
# Run on the CPU mesh (tests/conftest pattern); drop the env overrides to
# run on real devices.
set -e
cd "$(dirname "$0")/.."
export JAX_PLATFORMS=cpu
export XLA_FLAGS="--xla_force_host_platform_device_count=2 ${XLA_FLAGS}"

python - <<'PY'
# synthesize a 1.2 s FM-with-RDS capture (PI 0x52D4, PS "CSDR-JAX")
import sys
sys.path.insert(0, ".")
import numpy as np
from csdr_tpu.models import rds

quad = 192000.0
pi, ps = 0x52D4, "CSDR-JAX"
groups = [rds.make_group_0a(pi, s, ps[2 * s:2 * s + 2]) for s in range(4)]
g = rds.rds_receiver(quad)
n = (int(quad * 1.2) // g.granule) * g.granule
t = np.arange(n) / quad
L = 0.6 * np.sin(2 * np.pi * 800.0 * t)
R = 0.6 * np.sin(2 * np.pi * 2500.0 * t)
ph = 2 * np.pi * 19000.0 * t + 0.7
mpx = 0.45 * (L + R) + 0.1 * np.cos(ph) + 0.45 * (L - R) * np.cos(2 * ph)
tx = rds.bits_from_groups(groups)
bit = np.floor(t * rds.RDS_BAUD).astype(np.int64) % len(tx)
half = np.floor(t * 2 * rds.RDS_BAUD).astype(np.int64) % 2
lvl = (tx[bit] * 2.0 - 1.0) * np.where(half == 0, 1.0, -1.0)
mpx = 0.25 * (mpx + 0.12 * lvl * np.cos(3 * ph))
iq = np.exp(1j * np.cumsum(2 * np.pi * 0.8 * mpx)).astype(np.complex64)
iq.tofile("/tmp/ex12_cap.cf32")
print(f"wrote /tmp/ex12_cap.cf32 ({n} samples)")
PY

N=$(python -c "
import sys; sys.path.insert(0, '.')
from csdr_tpu.models import rds
g = rds.rds_receiver(192000.0)
print((int(192000*1.2)//g.granule)*g.granule)")

python -m csdr_tpu.apps.soapy_sdr_cli \
  --filename /tmp/ex12_cap.cf32 -s 192000 -n "$N" \
  --demod "DeFMS 4 WAV" --rds --mesh 2x1 -o /tmp/ex12_stereo

echo "--- decoded RDS ---"
cat /tmp/ex12_stereo.rds.txt
