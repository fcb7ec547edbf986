"""rtl_tcp network-bridge SDR driver — a real device path for `SdrSource`.

The reference's primary mode is live SoapySDR hardware
(/root/reference/src/ComposableSDR/Source.chs:193-233: setupStream/activate,
CF32, MTU-sized blocking reads, 1 s timeout → graceful end-of-stream).  Radio
hardware cannot exist on a data-centre host, but the rtl_tcp protocol (shipped with
librtlsdr; also spoken by SDR# / SoapyRemote bridges) lets a host with the
radio stream IQ over TCP.  This driver implements the client side:

  * on connect the server sends a 12-byte header: magic ``RTL0`` + tuner type
    (u32 BE) + tuner gain count (u32 BE);
  * the client configures the device with 5-byte commands
    ``u8 cmd ++ u32 BE argument`` — 0x01 set center frequency (Hz), 0x02 set
    sample rate (Hz), 0x03 set gain mode (0 auto / 1 manual), 0x04 set
    tuner gain (tenths of dB);
  * the server then streams interleaved unsigned-8-bit IQ forever.

Semantics mirror the reference: MTU-sized reads with a 1 s socket timeout;
a timeout (or server close) ends the stream gracefully rather than raising
(Source.chs:226-233).  Registered as the ``"rtl_tcp"`` driver with
io.sources.register_sdr_driver, so the CLI's device path
(``--devname rtl_tcp``) exercises it end-to-end.
"""

from __future__ import annotations

import os
import socket
import struct

import numpy as np

from .sources import SdrSource, register_sdr_driver

__all__ = ["RtlTcpSource", "RtlTcpServer", "RTL_MAGIC", "CMD_NAMES",
           "TUNER_NAMES"]

RTL_MAGIC = b"RTL0"

_CMD_FREQUENCY = 0x01
_CMD_SAMPLE_RATE = 0x02
_CMD_GAIN_MODE = 0x03
_CMD_GAIN = 0x04
_CMD_FREQ_CORRECTION = 0x05   # ppm, signed
_CMD_DIRECT_SAMPLING = 0x09   # 0 off / 1 I-branch / 2 Q-branch
_CMD_OFFSET_TUNING = 0x0A
_CMD_GAIN_INDEX = 0x0D        # tuner gain by index into the gain table
_CMD_BIAS_TEE = 0x0E          # librtlsdr >= 0.6 bias-T GPIO

# librtlsdr's full command set, for command-log introspection (the server
# records every command a client sends; gqrx/SDR# send several of these on
# connect)
CMD_NAMES = {
    0x01: "set_frequency", 0x02: "set_sample_rate", 0x03: "set_gain_mode",
    0x04: "set_gain", 0x05: "set_freq_correction", 0x06: "set_if_gain",
    0x07: "set_test_mode", 0x08: "set_agc_mode", 0x09: "set_direct_sampling",
    0x0A: "set_offset_tuning", 0x0B: "set_rtl_xtal", 0x0C: "set_tuner_xtal",
    0x0D: "set_gain_by_index", 0x0E: "set_bias_tee",
}

# rtl_tcp header tuner-type field -> dongle tuner name (librtlsdr enum) —
# the "dongle info" the wire actually carries
TUNER_NAMES = {0: "UNKNOWN", 1: "E4000", 2: "FC0012", 3: "FC0013",
               4: "FC2580", 5: "R820T", 6: "R828D"}

_U8_SCALE = np.float32(1.0 / 127.5)


class RtlTcpSource(SdrSource):
    """CF32 IQ over an rtl_tcp connection.

    ``raw_u8=True`` yields the wire's interleaved uint8 pairs instead of
    complex64 — feed those through blocks.u8_to_iq so the host→device wire
    carries 2 bytes/sample instead of 8 (conversion on the device).

    ``reconnect=N`` (or ``$CSDR_RTLTCP_RECONNECT``) re-dials up to N times
    after an unexpected disconnect/timeout, replaying the tuner config on
    the fresh connection; only after N consecutive failed dials does the
    stream end.  Default 0 keeps the reference's semantics: first
    timeout/close is a graceful EOS (Source.chs:226-233).

    Protocol depth (round 3): ``ppm`` sends set_freq_correction (0x05),
    ``bias_t`` powers the bias tee (0x0E), ``direct_sampling`` (0x09) and
    ``offset_tuning`` (0x0A) select the librtlsdr HF paths, and
    ``gain_index`` tunes by gain-table index (0x0D) instead of tenth-dB.
    All are replayed on every reconnect (an rtl_tcp server forgets tuner
    state with the connection).  ``tuner_name`` exposes the dongle's tuner
    chip parsed from the greeting header.
    """

    mtu = 1 << 17  # samples per read (MTU-sized like Source.chs:197)

    def __init__(self, sample_rate: float = 2.4e6, frequency: float = 100e6,
                 gain: float = 0.0, host: str | None = None,
                 port: int | None = None, timeout: float = 1.0,
                 raw_u8: bool = False, reconnect: int | None = None,
                 reconnect_wait: float = 0.1, gain_mode: str | None = None,
                 ppm: int = 0, bias_t: bool = False,
                 direct_sampling: int = 0, offset_tuning: bool = False,
                 gain_index: int | None = None):
        if host is None or port is None:
            addr = os.environ.get("CSDR_RTLTCP_ADDR", "127.0.0.1:1234")
            h, colon, p = addr.rpartition(":")
            if not colon or not p.isdigit():
                raise ValueError(
                    f"CSDR_RTLTCP_ADDR must be host:port, got {addr!r}")
            host = host or h
            port = port or int(p)
        if gain_mode not in (None, "auto", "manual"):
            raise ValueError(f"gain_mode must be 'auto'/'manual', got {gain_mode!r}")
        # protocol-wide convention (CLI -g, reference apps/SoapySDR.hs): gain
        # 0 means hardware AGC.  rtl-sdr tuners have a legal manual 0 dB step;
        # gain_mode="manual" selects it explicitly.
        self.gain_mode = gain_mode or ("manual" if gain else "auto")
        if direct_sampling not in (0, 1, 2):
            raise ValueError(
                f"direct_sampling must be 0/1/2, got {direct_sampling}")
        self.ppm = int(ppm)
        self.bias_t = bool(bias_t)
        self.direct_sampling = int(direct_sampling)
        self.offset_tuning = bool(offset_tuning)
        self.gain_index = gain_index
        self.raw_u8 = raw_u8
        self.sample_rate = sample_rate
        self.frequency = frequency
        self.gain = gain
        self.host, self.port = host, port
        self.timeout = timeout
        if reconnect is None:
            reconnect = int(os.environ.get("CSDR_RTLTCP_RECONNECT", "0"))
        self.reconnect = int(reconnect)
        self.reconnect_wait = float(reconnect_wait)
        self.reconnects = 0  # successful re-dials over the source's lifetime
        self._dial()

    def _dial(self):
        """Connect, validate the RTL0 header, push the device config.
        Shared by __init__ and mid-stream reconnection — an rtl_tcp server
        forgets all tuner state with the connection, so every (re)connect
        must replay sample rate / frequency / gain."""
        self.sock = socket.create_connection(
            (self.host, self.port), timeout=max(self.timeout, 5.0))
        self.sock.settimeout(self.timeout)  # 1 s read timeout (Source.chs:225)
        self._pend = b""  # dangling I byte of a half-received IQ pair
        hdr = self._recv_exact(12)
        if hdr is None or len(hdr) < 12 or hdr[:4] != RTL_MAGIC:
            self.sock.close()
            raise ConnectionError(
                f"not an rtl_tcp server at {self.host}:{self.port} "
                f"(header {hdr!r})")
        self.tuner_type, self.gain_count = struct.unpack(">II", hdr[4:])
        self._cmd(_CMD_SAMPLE_RATE, int(self.sample_rate))
        self._cmd(_CMD_FREQUENCY, int(self.frequency))
        if self.gain_index is not None:
            self._cmd(_CMD_GAIN_MODE, 1)
            self._cmd(_CMD_GAIN_INDEX, int(self.gain_index))
        elif self.gain_mode == "manual":
            self._cmd(_CMD_GAIN_MODE, 1)
            self._cmd(_CMD_GAIN, int(round(self.gain * 10.0)))
        else:
            self._cmd(_CMD_GAIN_MODE, 0)
        if self.ppm:
            # signed ppm rides the wire as a two's-complement u32 (librtlsdr
            # casts it straight back to int)
            self._cmd(_CMD_FREQ_CORRECTION, self.ppm)
        if self.direct_sampling:
            self._cmd(_CMD_DIRECT_SAMPLING, self.direct_sampling)
        if self.offset_tuning:
            self._cmd(_CMD_OFFSET_TUNING, 1)
        if self.bias_t:
            self._cmd(_CMD_BIAS_TEE, 1)

    def _try_reconnect(self) -> bool:
        """After an unexpected EOS: re-dial up to ``reconnect`` times with
        linear backoff (failure-detection depth the reference lacks — its
        Source.chs:226-233 can only Stop).  Samples lost during the outage
        are gone (live radio, not a file); I/Q pairing restarts clean on the
        fresh connection.  Returns False when the budget is exhausted, which
        becomes the usual graceful EOS."""
        import time

        try:
            self.sock.close()
        except OSError:
            pass
        for attempt in range(self.reconnect):
            time.sleep(self.reconnect_wait * (attempt + 1))
            try:
                self._dial()
            except (OSError, ConnectionError):
                continue
            self.reconnects += 1
            return True
        return False

    def _cmd(self, cmd: int, arg: int):
        self.sock.sendall(struct.pack(">BI", cmd, arg & 0xFFFFFFFF))

    def _recv_exact(self, n: int) -> bytes | None:
        """Read exactly n bytes; None on timeout/EOF (graceful EOS — the
        reference's timeout→Stop semantics, Source.chs:226-233)."""
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except (socket.timeout, OSError):
                return bytes(buf) if buf else None
            if not chunk:
                return bytes(buf) if buf else None
            buf.extend(chunk)
        return bytes(buf)

    def read(self):
        # A stalled server can hand _recv_exact an odd byte count; the
        # dangling I byte is carried in self._pend so the I/Q pairing never
        # desynchronizes across reads (dropping it would swap I/Q for the
        # rest of the stream).  A half-pair at EOS is discarded with it.
        while True:
            raw = self._recv_exact(self.mtu * 2 - len(self._pend))
            if not raw:
                if self._try_reconnect():
                    continue
                return None
            data = self._pend + raw
            keep = len(data) & ~1
            self._pend = data[keep:]
            if keep:
                break
        u8 = np.frombuffer(data[:keep], dtype=np.uint8)
        if self.raw_u8:
            return u8
        f = (u8.astype(np.float32) - 127.5) * _U8_SCALE
        pairs = f.reshape(-1, 2)
        return (pairs[:, 0] + 1j * pairs[:, 1]).astype(np.complex64)

    @property
    def tuner_name(self) -> str:
        """Dongle tuner chip, parsed from the greeting header."""
        return TUNER_NAMES.get(self.tuner_type, f"type{self.tuner_type}")

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class RtlTcpServer:
    """Serve IQ as an rtl_tcp server — the outbound half of the network
    story (the class above is the client).  Any chunk iterator (file source,
    synthetic device, a processed stream) becomes consumable by standard
    rtl_tcp clients (gqrx, SDR#, rtl_fm, or RtlTcpSource itself), so an accelerator
    pipeline can feed radio tooling elsewhere on the network.

    ``make_source()`` is called once per client connection and must return
    an iterator of chunks: complex64 in [-1, 1] (quantized to the wire's
    interleaved uint8 exactly like an RTL dongle) or uint8 (sent as-is).
    Tuner commands a client sends (set frequency/rate/gain) are recorded in
    ``self.commands`` — a file has a fixed tuning, like rtl_tcp serving a
    recorded stream.  Serves one client at a time, looping until close()
    (librtlsdr's rtl_tcp behaves the same way).

    gqrx compatibility: gqrx's "RTL-SDR via TCP" device connects, reads the
    12-byte greeting, immediately sends set_sample_rate + set_frequency (+
    gain/ppm commands as the UI changes), and expects a continuous u8 IQ
    stream — exactly this server's contract.  Every command is accepted and
    recorded (``commands_named()`` for a readable log); unknown command
    bytes are recorded too rather than desynchronizing the stream."""

    def __init__(self, make_source, host: str = "127.0.0.1", port: int = 0,
                 tuner_type: int = 5, gain_count: int = 29):
        import threading

        self.make_source = make_source
        self.tuner_type, self.gain_count = tuner_type, gain_count
        self.commands: list[tuple[int, int]] = []
        self.clients_served = 0
        self.error: Exception | None = None  # last source failure, if any
        self._closing = False
        self.srv = socket.socket()
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind((host, port))
        self.srv.listen(1)
        self.host, self.port = self.srv.getsockname()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    @staticmethod
    def _to_wire(chunk) -> bytes:
        a = np.asarray(chunk)
        if a.dtype == np.uint8:
            return a.tobytes()
        u8 = np.empty(2 * len(a), np.uint8)
        u8[0::2] = np.clip(np.round(a.real * 127.5 + 127.5), 0, 255)
        u8[1::2] = np.clip(np.round(a.imag * 127.5 + 127.5), 0, 255)
        return u8.tobytes()

    def _serve(self):
        import threading

        while not self._closing:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return  # close() shut the listener down
            try:
                conn.sendall(RTL_MAGIC
                             + struct.pack(">II", self.tuner_type,
                                           self.gain_count))
            except OSError:
                # client reset before reading the greeting (port scanner) —
                # keep accepting, a dead greeting must not kill the server
                conn.close()
                continue

            def drain(conn=conn):  # bind per-connection: the loop variable
                buf = b""          # rebinds on the next accept()
                try:
                    while True:
                        got = conn.recv(256)
                        if not got:
                            return
                        buf += got
                        while len(buf) >= 5:
                            cmd, arg = struct.unpack(">BI", buf[:5])
                            self.commands.append((cmd, arg))
                            buf = buf[5:]
                except OSError:
                    pass

            drainer = threading.Thread(target=drain, daemon=True)
            drainer.start()
            try:
                for chunk in self.make_source():
                    if self._closing:
                        break
                    conn.sendall(self._to_wire(chunk))
            except (BrokenPipeError, ConnectionResetError,
                    ConnectionAbortedError):
                pass  # client went away mid-stream: back to accept()
            except Exception as e:
                # a SOURCE failure (missing file, read error) must not be
                # mistaken for a client disconnect — record it loudly
                import sys as _sys

                self.error = e
                print(f"rtl_tcp server: source error: "
                      f"{type(e).__name__}: {e}", file=_sys.stderr)
            finally:
                self.clients_served += 1
                # Half-close, then wait for the client to finish: closing
                # outright while its config commands sit unread in our
                # receive buffer sends a TCP RST, which discards stream data
                # the client has not read yet and kills its concurrent
                # sendall (observed as a flaky ConnectionResetError in
                # RtlTcpSource._dial on short one-shot streams).  SHUT_WR
                # delivers a graceful EOF; the drain thread exits when the
                # client closes its side, and only then do we close.
                try:
                    conn.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                drainer.join(timeout=5)
                try:
                    conn.close()
                except OSError:
                    pass

    def commands_named(self) -> list[tuple[str, int]]:
        """The recorded client command log with librtlsdr command names."""
        return [(CMD_NAMES.get(c, f"cmd_0x{c:02x}"), a)
                for c, a in self.commands]

    def close(self):
        self._closing = True
        try:
            self.srv.close()
        except OSError:
            pass
        self.thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


register_sdr_driver("rtl_tcp", RtlTcpSource)
