#!/bin/sh
# Network loop: one process serves a capture over the rtl_tcp protocol, a
# second consumes it with --devname rtl_tcp and demodulates — the loop a
# radio host + accelerator server would run (the reference needs local USB hardware).
set -e
cd "$(dirname "$0")/.."
python - <<'PYEOF'
import numpy as np, sys
sys.path.insert(0, ".")
fs = 512000
n = 1 << 20
t = np.arange(n)
msg = 0.4*np.sin(2*np.pi*0.002*t)
(0.9*np.exp(1j*2*np.pi*0.6*np.cumsum(msg))).astype(np.complex64).tofile("/tmp/ex8_cap.cf32")
PYEOF
python -m csdr_tpu.apps.rtl_tcp_server --filename /tmp/ex8_cap.cf32 \
    --port 43210 --clients 1 &
SRV=$!
sleep 3
CSDR_RTLTCP_ADDR=127.0.0.1:43210 python -m csdr_tpu.apps.soapy_sdr_cli \
    --devname rtl_tcp -s 512e3 -f 100e6 -n 786432 \
    --demod "DeNBFM 0.6 WAV" --blocksize 65536 -o /tmp/ex8_radio
wait $SRV
ls -l /tmp/ex8_radio.wav
