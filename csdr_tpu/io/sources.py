"""Sample sources.

Reference layer L4 (/root/reference/src/ComposableSDR/Source.chs): SoapySDR
device streams, raw CF32 files, and WAV audio files lifted to IQ.  Here every
source is a plain iterator of numpy arrays feeding core/runtime.Pipeline; the
native C++ double-buffered file reader (native/csdr_io.cpp) is used when built,
with a numpy fallback.

The SDR-device source is a pluggable interface: real SoapySDR hardware does
not exist on a data-centre host, so `SdrSource` defines the protocol (open/read/close,
MTU-sized reads, CF32) and `SyntheticSdrSource` provides a deterministic
stand-in used by tests and demos.  A SoapySDR-backed implementation can
register via `register_sdr_driver`.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

from . import wav as wavio

__all__ = [
    "cf32_file_source",
    "cu8_file_source",
    "f32_file_source",
    "raw_bytes_source",
    "wav_iq_source",
    "SdrSource",
    "SyntheticSdrSource",
    "register_sdr_driver",
    "enumerate_devices",
    "open_sdr",
]

_CHUNK = 1 << 18


def cf32_file_source(path: str, chunk_size: int = _CHUNK) -> Iterator[np.ndarray]:
    """Stream complex64 samples from a raw .cf32 file (reference
    readFromFile, Source.chs:259-271; default chunk 1024 there — we default
    much larger because the consumer re-blocks anyway)."""
    gen = None
    try:
        from .native import native_cf32_source
        gen = native_cf32_source(path, chunk_size)
        first = next(gen)
    except StopIteration:
        return
    except Exception:
        gen = None  # native lib unavailable/failed to open → numpy fallback
    if gen is not None:
        # past the first yield, a native failure must PROPAGATE — falling
        # back would re-open at byte 0 and silently duplicate samples
        yield first
        yield from gen
        return
    with open(path, "rb") as f:
        while True:
            raw = f.read(chunk_size * 8)
            if len(raw) < 8:
                return  # EOF (a trailing partial sample is dropped)
            yield np.frombuffer(raw[: len(raw) & ~7], dtype=np.complex64)


def cu8_file_source(path: str, chunk_size: int = _CHUNK) -> Iterator[np.ndarray]:
    """Raw interleaved uint8 IQ (rtl_sdr capture format): yields uint8 arrays
    of even length; pair conversion happens on device (blocks.u8_to_iq)."""
    with open(path, "rb") as f:
        while True:
            raw = f.read(chunk_size * 2)
            if not raw:
                return
            buf = np.frombuffer(raw, dtype=np.uint8)
            yield buf[: len(buf) & ~1]


def raw_bytes_source(path: str, chunk_bytes: int = _CHUNK) -> Iterator[np.ndarray]:
    """Untyped byte tap: yields uint8 arrays straight from the file
    (reference `readBytes`, Source.chs:4 — the raw-byte variant of the
    device/file readers).  Use when downstream interprets the framing itself
    (e.g. u8_to_iq on device, or a custom packet decoder)."""
    with open(path, "rb") as f:
        while True:
            raw = f.read(chunk_bytes)
            if not raw:
                return
            yield np.frombuffer(raw, dtype=np.uint8)


def f32_file_source(path: str, chunk_size: int = _CHUNK) -> Iterator[np.ndarray]:
    with open(path, "rb") as f:
        while True:
            raw = f.read(chunk_size * 4)
            if len(raw) < 4:
                return  # EOF (a trailing partial sample is dropped)
            yield np.frombuffer(raw[: len(raw) & ~3], dtype=np.float32)


def wav_iq_source(path: str, chunk_size: int = _CHUNK) -> Iterator[np.ndarray]:
    """Mono WAV → IQ: Hilbert real→complex (2:1) then mix by π, exactly the
    reference's audio-file source (Source.chs:273-307: realToComplex then
    mixUp(2π·0.5)).  Raises on non-mono input like the reference
    (Source.chs:283)."""
    from ..core.block import chain
    from ..core.runtime import Pipeline
    from ..blocks import real_to_complex, mix_up

    data, _sr = wavio.read_wav(path)
    if data.ndim != 1:
        raise ValueError("wav_iq_source: only mono WAV supported (like the reference)")
    blk = chain(real_to_complex(), mix_up(np.pi))
    # run through the jitted Pipeline, not eager blk.apply: one compiled
    # step per chunk, and Pipeline trims the short final block to the
    # exact rational count
    yield from Pipeline(blk, block_size=chunk_size * 2).stream(iter([data]))


class SdrSource:
    """Device-source protocol (reference SoapySDR wrapper,
    Source.chs:103-257: enumerate/open/configure, CF32 stream, MTU reads,
    1 s timeout, graceful end-of-stream on timeout)."""

    mtu: int = 1 << 17

    def read(self) -> np.ndarray | None:
        """One MTU-sized CF32 chunk, or None on timeout (ends the stream —
        matching the reference's timeout semantics, Source.chs:226-233)."""
        raise NotImplementedError

    def close(self):
        pass

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            chunk = self.read()
            if chunk is None or len(chunk) == 0:
                self.close()
                return
            yield chunk


class SyntheticSdrSource(SdrSource):
    """Deterministic multi-tone + noise 'device' for tests/demos."""

    def __init__(self, sample_rate: float = 2.56e6, frequency: float = 100e6,
                 gain: float = 0.0, total_samples: int = 1 << 22, seed: int = 0,
                 tones: tuple[float, ...] = (-0.3, -0.05, 0.1, 0.27)):
        self.sample_rate = sample_rate
        self.frequency = frequency
        self.gain = gain
        self.remaining = total_samples
        self.rng = np.random.default_rng(seed)
        self.tones = tones
        self.n = 0

    def read(self):
        if self.remaining <= 0:
            return None
        m = min(self.mtu, self.remaining)
        t = np.arange(self.n, self.n + m)
        x = np.zeros(m, dtype=np.complex128)
        for i, f in enumerate(self.tones):
            x += (0.5 / (i + 1)) * np.exp(2j * np.pi * np.mod(f * t, 1.0))
        x += 0.01 * (self.rng.normal(size=m) + 1j * self.rng.normal(size=m))
        self.n += m
        self.remaining -= m
        return x.astype(np.complex64)


_DRIVERS: dict[str, Callable[..., SdrSource]] = {"synthetic": SyntheticSdrSource}


def register_sdr_driver(name: str, factory: Callable[..., SdrSource]):
    _DRIVERS[name] = factory


def _load_soapy_shim():
    """Import the gated SoapySDR shim (io/soapy.py), which registers its
    drivers on import when the SoapySDR module exists.  Deferred to call
    time: soapy.py imports from this module, and SoapySDR hardware is the
    exception, not the rule, on accelerator hosts."""
    try:
        from . import soapy
        # re-invoke explicitly rather than relying on the first-import side
        # effect: if soapy was first imported while SoapySDR was missing,
        # the cached module registered nothing — but SoapySDR may be
        # importable NOW (late install / test-injected sys.modules entry)
        soapy.register_if_available()
    except Exception:
        pass


def enumerate_devices() -> list[dict]:
    """List available 'devices' (reference CS.enumerate, Source.chs:109-121)."""
    _load_soapy_shim()
    devs = [{"driver": name} for name in _DRIVERS]
    return devs


def open_sdr(devname: str, sample_rate: float, frequency: float, gain: float,
             **kw) -> SdrSource:
    if devname not in _DRIVERS:
        _load_soapy_shim()
    if devname not in _DRIVERS:
        raise KeyError(f"SDR driver {devname!r} not found; have {list(_DRIVERS)}")
    return _DRIVERS[devname](sample_rate=sample_rate, frequency=frequency, gain=gain, **kw)
