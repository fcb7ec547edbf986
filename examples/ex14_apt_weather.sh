#!/bin/sh
# ex14: NOAA APT weather imagery (round-5 extension receiver) — synthesize
# an APT transmission (sync trains + two video channels), decode it back to
# a calibrated PGM image with the offline decoder.  With a real 137 MHz
# capture you'd first WBFM-demod (.cf32 input does this in one step:
# `apt_decode capture.cf32 -s 33280`).
set -e
cd "$(dirname "$0")/.."
export JAX_PLATFORMS=cpu

python - <<'PY'
import sys
sys.path.insert(0, ".")
import numpy as np
from csdr_tpu.models import apt

FS = 8 * apt.WORD_RATE        # 33.28 kHz audio
lines = 16
img = np.zeros((lines, apt.LINE_WORDS), np.float64)
t = np.arange(909)
for ln in range(lines):
    img[ln, :39] = apt.SYNC_A * 233 + 11           # sync A at spec levels
    img[ln, 39:86] = 11                            # space A (black)
    img[ln, 86:995] = 128 + 110 * np.sin(          # video A: rolling waves
        2 * np.pi * (t / 909 * 3 + ln / lines))
    img[ln, 995:1040] = 20 * (ln * 8 // lines) + 30  # telemetry wedges
    img[ln, 1040:1079] = np.pad(apt.SYNC_B, (0, 0)) * 233 + 11
    img[ln, 1079:1126] = 11
    img[ln, 1126:2035] = np.clip(255 * t / 909, 0, 255)  # video B: ramp
    img[ln, 2035:] = 200
img = np.asarray(np.rint(img), np.uint8)
apt.apt_modulate(img, FS).tofile("/tmp/ex14_apt.f32")
print(f"wrote /tmp/ex14_apt.f32 ({lines} lines at {FS:.0f} Hz)")
PY

python -m csdr_tpu.apps.apt_decode /tmp/ex14_apt.f32 -s 33280 \
    -o /tmp/ex14_wx.pgm --channel a

python - <<'PY'
raw = open("/tmp/ex14_wx.pgm", "rb").read()
w, h = (int(v) for v in raw.split(b"\n")[1].split())
print(f"decoded image: {w}x{h} PGM at /tmp/ex14_wx.pgm")
PY
