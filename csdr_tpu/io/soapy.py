"""SoapySDR-backed ``SdrSource`` driver shim.

Behavioral port of the reference's SoapySDR wrapper
(/root/reference/src/ComposableSDR/Source.chs:103-257): enumerate devices,
make one from ``{"driver": name}`` kwargs, configure RX channel 0
(sample rate, frequency; ``gain == 0`` enables hardware AGC, any other
value sets manual overall gain — Source.chs:152-166), set up a CF32
stream with 30 buffers, and read MTU-sized chunks with a 1 s timeout
where a timeout/error ends the stream gracefully (Source.chs:226-233).

The Python ``SoapySDR`` module is NOT part of this environment (real
SoapySDR hardware does not exist on a data-centre host), so everything is lazily
imported and registry-gated: importing this module is always safe, and
``register_if_available()`` only adds drivers when ``import SoapySDR``
succeeds (e.g. a deployment box with SoapySDR-remote talking to antenna
hosts).  Tests inject a fake ``SoapySDR`` module to exercise the full
open/configure/stream/close protocol without hardware.
"""

from __future__ import annotations

import numpy as np

from .sources import SdrSource, register_sdr_driver

__all__ = [
    "SoapySdrSource",
    "available",
    "enumerate_soapy_devices",
    "register_if_available",
]

_SOAPY_SDR_RX = 1          # SoapySDR.SOAPY_SDR_RX
_TIMEOUT_US = 1_000_000    # reference reads with a 1 s timeout


def _import_soapy():
    try:
        import SoapySDR  # type: ignore
        return SoapySDR
    except ImportError:
        return None


def available() -> bool:
    return _import_soapy() is not None


def enumerate_soapy_devices() -> list[dict]:
    """Device kwargs dicts, one per device (reference ``enumerate``,
    Source.chs:109-121).  Empty when SoapySDR is absent."""
    mod = _import_soapy()
    if mod is None:
        return []
    return [dict(kw) for kw in mod.Device.enumerate()]


class SoapySdrSource(SdrSource):
    """One RX channel of a SoapySDR device as a CF32 chunk source."""

    def __init__(self, sample_rate: float, frequency: float, gain: float = 0.0,
                 driver: str = "rtlsdr", channel: int = 0,
                 device_args: dict | None = None, _module=None, **kw):
        mod = _module if _module is not None else _import_soapy()
        if mod is None:
            raise RuntimeError(
                "SoapySDR is not importable; use the rtl_tcp or synthetic "
                "driver, or install SoapySDR on a host with hardware")
        self._mod = mod
        rx = getattr(mod, "SOAPY_SDR_RX", _SOAPY_SDR_RX)
        cf32 = getattr(mod, "SOAPY_SDR_CF32", "CF32")
        args = {"driver": driver}
        args.update(device_args or {})
        self._dev = mod.Device(args)
        self._ch = channel
        self._rx = rx
        self.sample_rate = sample_rate
        self.frequency = frequency
        self.gain = gain
        self._dev.setSampleRate(rx, channel, float(sample_rate))
        self._dev.setFrequency(rx, channel, float(frequency))
        if gain == 0.0:
            # reference semantics: gain 0 = hardware AGC (Source.chs:158)
            self._dev.setGainMode(rx, channel, True)
        else:
            self._dev.setGain(rx, channel, float(gain))
        # reference requests 30 stream buffers (Source.chs:201)
        self._stream = self._dev.setupStream(rx, cf32, [channel],
                                             {"buffers": "30"})
        self._dev.activateStream(self._stream)
        mtu = int(self._dev.getStreamMTU(self._stream))
        self.mtu = mtu if mtu > 0 else SdrSource.mtu
        self._buf = np.empty(self.mtu, np.complex64)
        self._closed = False

    def read(self) -> np.ndarray | None:
        """One MTU-sized CF32 chunk; None on timeout/error (stream end)."""
        if self._closed:
            return None
        sr = self._dev.readStream(self._stream, [self._buf], self.mtu,
                                  timeoutUs=_TIMEOUT_US)
        # SoapySDR returns either an int or a StreamResult with .ret
        n = int(getattr(sr, "ret", sr))
        if n <= 0:  # timeout (-1) / error codes end the stream, ref :226-233
            return None
        return self._buf[:n].copy()

    def close(self):
        if self._closed:
            return
        self._closed = True
        for op in (lambda: self._dev.deactivateStream(self._stream),
                   lambda: self._dev.closeStream(self._stream)):
            try:
                op()
            except Exception:  # mirror the reference's `try` (ignore) on teardown
                pass


def register_if_available() -> bool:
    """Register ``soapy`` (plus one name per detected hardware driver) in the
    SdrSource registry.  No-op without the SoapySDR module."""
    if not available():
        return False
    register_sdr_driver("soapy", SoapySdrSource)
    for kw in enumerate_soapy_devices():
        drv = kw.get("driver")
        if drv and drv != "soapy":
            register_sdr_driver(
                drv, lambda sample_rate, frequency, gain=0.0, _d=drv, **k:
                SoapySdrSource(sample_rate, frequency, gain, driver=_d, **k))
    return True


register_if_available()
