#!/bin/sh
# ex16: WEFAX (HF radiofax) — synthesize a marine-chart transmission with
# its phasing train, decode it back (phasing auto-alignment) into a PGM.
set -e
cd "$(dirname "$0")/.."
export JAX_PLATFORMS=cpu

python - <<'PY'
import sys
sys.path.insert(0, ".")
import numpy as np
from csdr_tpu.models import wefax

FS = 12000.0
lines = 16
t = np.arange(wefax.PX_PER_LINE)
img = np.zeros((lines, wefax.PX_PER_LINE), np.float64)
for ln in range(lines):          # isobar-like slow sinusoids on white
    img[ln] = 230 - 180 * (0.5 + 0.5 * np.sin(
        2 * np.pi * (ln + 2) * t / wefax.PX_PER_LINE + 0.3 * ln))
img = np.asarray(np.rint(img), np.uint8)
wefax.wefax_modulate(img, FS).tofile("/tmp/ex16_wefax.f32")
print(f"wrote /tmp/ex16_wefax.f32 ({lines} chart lines + phasing train, "
      f"120 lpm IOC 576)")
PY

python -m csdr_tpu.apps.wefax_decode /tmp/ex16_wefax.f32 -s 12000 \
    -o /tmp/ex16_chart.pgm
