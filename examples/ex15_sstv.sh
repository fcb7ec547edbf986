#!/bin/sh
# ex15: SSTV (Martin M1) — modulate an RGB test card to audio, decode it
# back (VIS auto-detect) into a color PPM.
set -e
cd "$(dirname "$0")/.."
export JAX_PLATFORMS=cpu

python - <<'PY'
import sys
sys.path.insert(0, ".")
import numpy as np
from csdr_tpu.models import sstv

FS = 11025.0
lines, px = 24, 320
t = np.arange(px)
img = np.zeros((lines, px, 3), np.float64)
for ln in range(lines):
    img[ln, :, 0] = 128 + 120 * np.sin(2 * np.pi * (t / px + ln / lines))
    img[ln, :, 1] = np.clip(255 * t / px, 0, 255)
    img[ln, :, 2] = 255 * (ln / lines)
img = np.asarray(np.rint(img), np.uint8)
sstv.sstv_modulate(img, FS, mode="martin1").tofile("/tmp/ex15_sstv.f32")
print(f"wrote /tmp/ex15_sstv.f32 ({lines} lines, Martin M1 + VIS header)")
PY

python -m csdr_tpu.apps.sstv_decode /tmp/ex15_sstv.f32 -s 11025 \
    -o /tmp/ex15_img.ppm
