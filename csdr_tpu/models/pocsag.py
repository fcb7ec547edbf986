"""POCSAG pager receiver — ITU-R M.584 codewords from 2-FSK baseband.

Capability extension beyond the reference (whose offline decoder is the
helicopter FSK app, /root/reference/apps/HeliDecode.hs); POCSAG is the
classic paging protocol the same shape of problem lands on land-mobile:
512/1200/2400 baud direct FSK (±4.5 kHz), 32-bit codewords protected by
BCH(31,21) + even parity, batches of 16 codewords behind a frame sync.

Split like models/ais.py: the sample-rate part (FM discriminator + one-bit
integrator) is a Block chain on device (shards under a mesh); the irregular
part (sync search, BCH error correction, address/message assembly) runs
host-side on the tiny kilobit/s bit stream.

Wire conventions implemented (the test encoder mirrors them, so the chain is
validated as an exact inverse pair):
  * preamble ≥576 bits of 1010…, then batches of [SYNC + 8 frames × 2
    codewords]; SYNC = 0x7CD215D8, IDLE = 0x7A89C197 (both themselves valid
    BCH codewords — the test suite checks this as a generator self-test);
  * codeword = 21 data bits · x^10 + BCH(31,21) remainder (generator
    x^10+x^9+x^8+x^6+x^5+x^3+1 = 0x769), then an even-parity bit;
  * address codeword (MSB 0): 18 address bits + 2 function bits; the full
    21-bit RIC = addr18·8 + frame number the codeword sits in;
  * message codewords (MSB 1) carry 20 payload bits each; alphanumeric
    messages pack 7-bit ASCII LSB-first (fn=3), numeric messages pack
    4-bit digits LSB-first with multimon-ng's charset (fn=0);
  * on-air polarity is commonly inverted — the decoder tries both.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Block, chain
from ..blocks import FIRFilter, fm_demodulator
from .hdlc import sample_bits

__all__ = [
    "pocsag_receiver", "bits_from_score", "decode_score", "decode_bits",
    "decode_channels", "pocsag_band_monitor",
    "bch_encode", "correct_codeword", "SYNC", "IDLE",
    "make_transmission", "pocsag_modulate", "POCSAG_BAUDS",
]

SYNC = 0x7CD215D8
IDLE = 0x7A89C197
_GEN = 0x769  # BCH(31,21) generator x^10+x^9+x^8+x^6+x^5+x^3+1
POCSAG_BAUDS = (512.0, 1200.0, 2400.0)
_NUM_CS = "0123456789*U -)("  # multimon-ng numeric charset


def pocsag_receiver(sample_rate: float, baud: float = 1200.0,
                    deviation: float = 4500.0) -> Block:
    """cf32 FSK baseband at ``sample_rate`` (n×baud) → per-sample bit score
    at the same rate (discriminator normalized to ±1 at ``deviation``,
    integrated over one bit).  Polarity is resolved host-side."""
    k = sample_rate / baud
    if abs(k - round(k)) > 1e-9 or round(k) < 4:
        raise ValueError(
            f"POCSAG needs sample_rate = n·{baud:g} with n ≥ 4, "
            f"got {sample_rate}")
    k = int(round(k))
    ma = np.ones(k) / k
    return chain(fm_demodulator(deviation / sample_rate),
                 FIRFilter(ma, complex_input=False, name=f"bit_ma({k})"))


# ---- host-side bit layer ----------------------------------------------------

def bits_from_score(score: np.ndarray, sample_rate: float,
                    baud: float = 1200.0) -> np.ndarray:
    """Bit-center sampling (the shared open-loop bit clock,
    models/hdlc.sample_bits).  Positive discriminator (higher frequency) =
    bit level 1; POCSAG's inversion convention is handled by the
    dual-polarity sync search in decode_bits."""
    return sample_bits(score, int(round(sample_rate / baud)))


def decode_score(score: np.ndarray, sample_rate: float,
                 baud: float = 1200.0) -> list[dict]:
    return decode_bits(bits_from_score(score, sample_rate, baud))


def pocsag_band_monitor(nch: int, channel_rate: float, baud: float = 1200.0,
                        deviation: float = 4500.0) -> Block:
    """A whole paging band in ONE device graph: PFB split into nch channels,
    then per channel a Tee of (bit score, envelope magnitude) — the device
    scale-out story (channels are a tensor axis; the reference fans out one
    liquid demod per channel, apps/SoapySDR.hs:224-225).  Input: wideband
    cf32 at nch·channel_rate.  Output: ((nch, n) scores, (nch, n) env);
    feed CollectSink.concat() to decode_channels."""
    import jax.numpy as jnp

    from ..core.block import Lambda, Tee
    from .receivers import channelized_receiver

    per = Tee(pocsag_receiver(channel_rate, baud, deviation),
              Lambda(jnp.abs, name="env"))
    return channelized_receiver(nch, per, sample_rate=nch * channel_rate)


def decode_channels(collected, channel_rate: float, baud: float = 1200.0,
                    min_snr: float = 3.0) -> list[dict]:
    """Decode the band monitor's output.  The FM discriminator is
    amplitude-blind, so a page leaks a decodable score into neighboring
    channels through the PFB stopband — the envelope branch gates channels
    to those whose mean magnitude clears ``min_snr``× the band's median
    (the noise floor while most channels are idle).  Each message dict
    gains a 'channel' key.  A bare (nch, n) score array (no envelope
    branch) decodes every channel ungated."""
    if isinstance(collected, tuple):
        scores, env = (np.asarray(a) for a in collected)
        power = env.mean(axis=-1)
        active = power >= min_snr * (np.median(power) + 1e-12)
    else:
        scores = np.asarray(collected)
        active = np.ones(len(scores), bool)
    out = []
    for ch, row in enumerate(scores):
        if active[ch]:
            for m in decode_score(row, channel_rate, baud):
                out.append(dict(m, channel=ch))
    return out


def _bch_remainder(x31: int) -> int:
    for shift in range(20, -1, -1):
        if x31 & (1 << (shift + 10)):
            x31 ^= _GEN << shift
    return x31


def bch_encode(data21: int) -> int:
    """21 data bits → 32-bit codeword (BCH check bits + even parity)."""
    x = (data21 & 0x1FFFFF) << 10
    cw31 = x | _bch_remainder(x)
    return (cw31 << 1) | (bin(cw31).count("1") & 1)


def _valid(cw32: int) -> bool:
    return (bin(cw32).count("1") & 1) == 0 and _bch_remainder(cw32 >> 1) == 0


def correct_codeword(cw32: int) -> int | None:
    """Return the nearest valid codeword within Hamming distance 2 (the
    BCH(31,21) design distance), or None."""
    if _valid(cw32):
        return cw32
    for i in range(32):
        c1 = cw32 ^ (1 << i)
        if _valid(c1):
            return c1
        for j in range(i + 1, 32):
            if _valid(c1 ^ (1 << j)):
                return c1 ^ (1 << j)
    return None


def _hamming32(a: int, b: int) -> int:
    return bin(a ^ b).count("1")


def _words(bits: np.ndarray) -> np.ndarray:
    """All overlapping 32-bit big-endian words of a bit vector (uint64)."""
    w = np.zeros(max(len(bits) - 31, 0), np.uint64)
    b = np.asarray(bits, np.uint64)
    for i in range(32):
        w |= b[i:i + len(w)] << np.uint64(31 - i)
    return w


def _alpha(payload: list[int]) -> str:
    bits = [(p >> (19 - i)) & 1 for p in payload for i in range(20)]
    out = []
    for i in range(0, len(bits) - 6, 7):
        c = sum(bit << j for j, bit in enumerate(bits[i:i + 7]))  # LSB first
        out.append(chr(c))
    return "".join(out).rstrip("\x00\x04")


def _numeric(payload: list[int]) -> str:
    out = [_NUM_CS[_rev4((p >> (16 - 4 * i)) & 0xF)]
           for p in payload for i in range(5)]
    return "".join(out).rstrip(" ")


def decode_bits(levels: np.ndarray) -> list[dict]:
    """Sync search (both polarities, ≤2 sync bit errors) → batch walk →
    BCH-correct every codeword → address/message assembly."""
    levels = np.asarray(levels, np.uint8)
    best: list[dict] = []
    for pol in (levels, 1 - levels):
        msgs = _decode_polarity(pol)
        if len(msgs) > len(best):
            best = msgs
    return best


def _decode_polarity(levels: np.ndarray) -> list[dict]:
    words = _words(levels)
    msgs: list[dict] = []
    cur: dict | None = None

    def flush():
        nonlocal cur
        if cur is not None and (cur["payload"] or cur["kind"] != "alpha"):
            cur["text"] = (_alpha(cur["payload"]) if cur["fn"] == 3
                           else _numeric(cur["payload"]) if cur["fn"] == 0
                           else "")
            cur.pop("payload")
            msgs.append(cur)
        cur = None

    pos = 0
    while pos < len(words):
        window = 4000
        sync_at = np.flatnonzero(
            np.array([_hamming32(int(w), SYNC) for w in words[pos:pos + window]])
            <= 2)
        if not len(sync_at):
            pos += window  # keep scanning: pages may sit seconds apart
            continue
        pos += int(sync_at[0])
        while pos < len(words) and _hamming32(int(words[pos]), SYNC) <= 2:
            pos += 32  # past the sync codeword
            for slot in range(16):
                if pos >= len(words):
                    break
                cw = correct_codeword(int(words[pos]))
                pos += 32
                if cw is None or cw == IDLE:
                    flush()
                    continue
                if cw & 0x80000000:  # message codeword
                    if cur is not None:
                        cur["payload"].append((cw >> 11) & 0xFFFFF)
                else:  # address codeword
                    flush()
                    addr18 = (cw >> 13) & 0x3FFFF
                    fn = (cw >> 11) & 0x3
                    cur = {"ric": addr18 * 8 + slot // 2, "fn": fn,
                           "kind": "alpha" if fn == 3 else
                                   "numeric" if fn == 0 else f"fn{fn}",
                           "payload": []}
        flush()
    return msgs


# ---- test-vector encoder (exact inverse of the decoder) ---------------------

def _encode_alpha(text: str) -> list[int]:
    bits = [(ord(c) >> j) & 1 for c in text for j in range(7)]  # LSB first
    while len(bits) % 20:
        bits.append(0)
    return [sum(bit << (19 - i) for i, bit in enumerate(bits[p:p + 20]))
            for p in range(0, len(bits), 20)]


def _rev4(v: int) -> int:
    return sum(((v >> j) & 1) << (3 - j) for j in range(4))


def _encode_numeric(digits: str) -> list[int]:
    nibs = [_rev4(_NUM_CS.index(c)) for c in digits]
    while len(nibs) % 5:
        nibs.append(_rev4(_NUM_CS.index(" ")))  # pad with spaces
    return [sum(n << (16 - 4 * i) for i, n in enumerate(nibs[p:p + 5]))
            for p in range(0, len(nibs), 5)]


def make_transmission(ric: int, message: str, fn: int | None = None,
                      preamble: int = 576) -> np.ndarray:
    """Preamble + sync'd batches carrying one address + message codewords,
    idle-filled, as over-the-air bit LEVELS (non-inverted polarity)."""
    if fn is None:
        fn = 0 if all(c in _NUM_CS for c in message) else 3
    payload = _encode_alpha(message) if fn == 3 else _encode_numeric(message)
    frame = ric & 7
    addr_cw = bch_encode(((ric >> 3) & 0x3FFFF) << 2 | fn)
    body = [IDLE] * (2 * frame) + [addr_cw] + [
        bch_encode(0x100000 | p) for p in payload]
    while len(body) % 16:
        body.append(IDLE)
    bits = [1, 0] * (preamble // 2)
    for b in range(0, len(body), 16):
        for cw in [SYNC] + body[b:b + 16]:
            bits.extend((cw >> (31 - i)) & 1 for i in range(32))
    return np.array(bits, np.uint8)


def pocsag_modulate(levels: np.ndarray, sample_rate: float,
                    baud: float = 1200.0, deviation: float = 4500.0,
                    invert: bool = True) -> np.ndarray:
    """Continuous-phase 2-FSK synthesis: bit level 1 = −deviation when
    ``invert`` (the common on-air POCSAG convention), +deviation otherwise
    (test oracle transmitter)."""
    k = int(round(sample_rate / baud))
    sign = -1.0 if invert else 1.0
    freqs = sign * deviation * (2.0 * np.repeat(
        np.asarray(levels, np.float64), k) - 1.0)
    phase = 2.0 * np.pi * np.cumsum(freqs) / sample_rate
    return np.exp(1j * phase).astype(np.complex64)
