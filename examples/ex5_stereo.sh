#!/bin/sh
# Stereo FM + RDS: generated MPX composite (pilot-locked 57 kHz RDS carrying
# a PS name and RadioText), FM-modulated -> stereo WAV + decoded RDS text
set -e
cd "$(dirname "$0")/.."
python - <<'PYEOF'
import numpy as np, sys
sys.path.insert(0, ".")
from csdr_tpu.utils import testsig
from csdr_tpu.models import rds
quad = 192000.0
n = 1 << 20
t = np.arange(n)/quad
L = 0.6*np.sin(2*np.pi*500.0*t); R = 0.6*np.sin(2*np.pi*1800.0*t)
pilot_ph = 2*np.pi*19000*t
mpx = 0.45*(L+R) + 0.1*np.cos(pilot_ph) + 0.45*(L-R)*np.cos(2*pilot_ph)
ps, rt = "CSDR-JAX", "JAX NATIVE RADIO"
groups = [rds.make_group_0a(0x52D4, s, ps[2*s:2*s+2]) for s in range(4)]
groups += [rds.make_group_2a(0x52D4, s, rt[4*s:4*s+4]) for s in range(4)]
tx = rds.bits_from_groups(groups)
bi = np.floor(t*rds.RDS_BAUD).astype(np.int64) % len(tx)
half = np.floor(t*2*rds.RDS_BAUD).astype(np.int64) % 2
mpx += 0.12*(tx[bi]*2.0-1.0)*np.where(half == 0, 1.0, -1.0)*np.cos(3*pilot_ph)
testsig.fm_mod((0.3*mpx).astype(np.float32), 0.8).tofile("/tmp/ex5_fms.cf32")
PYEOF
python -m csdr_tpu.apps.soapy_sdr_cli --filename /tmp/ex5_fms.cf32 \
    -s 192e3 -n 1048576 --demod "DeFMS 4 WAV" --rds -o /tmp/ex5_stereo
ls -l /tmp/ex5_stereo.wav
cat /tmp/ex5_stereo.rds.txt
