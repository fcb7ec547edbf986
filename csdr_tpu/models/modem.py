"""Digital modem support: constellations, hard decisions, soft (LLR) outputs.

The reference instantiates liquid's symtrack with the BPSK modem only
(LIQUID_MODEM ms=21 — /root/reference/src/ComposableSDR/Liquid.chs:158-166),
but liquid's surface carries the whole modem family.  This module provides
the block-parallel core: gray-mapped unit-energy constellation tables, and
decision/LLR kernels shaped as batched table operations —

  * hard decision: argmax over Re(y·c̄) − |c|²/2, one (n, M) matmul-like
    panel op instead of liquid's per-sample nested loops;
  * soft decision: exact max-log LLRs from the same (n, M) distance panel
    with per-bit masked minima.

Used by models/symsync.sym_tracker (QPSK/QAM tracking + soft outputs) and
usable standalone for offline demodulation.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.block import Block
from ..ops.constants import jnp_const

__all__ = ["CONSTELLATIONS", "constellation", "bits_per_symbol", "modulate",
           "hard_decision", "soft_llrs", "symbols_to_bits", "SoftDecision",
           "soft_decision", "coded_packet_modulate", "coded_packet_demodulate"]


def _gray(n: int) -> np.ndarray:
    k = np.arange(n)
    return k ^ (k >> 1)


@functools.lru_cache(maxsize=None)
def constellation(ms: str) -> np.ndarray:
    """Gray-mapped, unit-average-energy constellation, indexed by the
    transmitted bit pattern (MSB first)."""
    if ms == "bpsk":
        return np.array([-1.0 + 0j, 1.0 + 0j], dtype=np.complex128)
    if ms == "qpsk":
        # bits (b1, b0) → (I, Q), gray per axis
        pts = np.array([(-1 - 1j), (-1 + 1j), (1 - 1j), (1 + 1j)],
                       dtype=np.complex128)
        return pts / np.sqrt(2.0)
    if ms == "8psk":
        # index g gray-coded around the circle
        g = _gray(8)
        pts = np.empty(8, dtype=np.complex128)
        for k in range(8):
            pts[g[k]] = np.exp(2j * np.pi * k / 8.0)
        return pts
    if ms in ("qam16", "qam64"):
        side = 4 if ms == "qam16" else 8
        b_ax = side.bit_length() - 1  # bits per axis
        levels = (2 * np.arange(side) - (side - 1)).astype(np.float64)
        # gray-map each axis: axis bits g → level position
        pos = np.empty(side, dtype=np.int64)
        g = _gray(side)
        for k in range(side):
            pos[g[k]] = k
        pts = np.empty(side * side, dtype=np.complex128)
        for bi in range(side):
            for bq in range(side):
                idx = (bi << b_ax) | bq
                pts[idx] = levels[pos[bi]] + 1j * levels[pos[bq]]
        return pts / np.sqrt(np.mean(np.abs(pts) ** 2))
    raise ValueError(f"unknown modulation {ms!r}; have bpsk/qpsk/8psk/"
                     f"qam16/qam64")


CONSTELLATIONS = ("bpsk", "qpsk", "8psk", "qam16", "qam64")


def bits_per_symbol(ms: str) -> int:
    return int(np.log2(len(constellation(ms))))


def modulate(bits: np.ndarray, ms: str) -> np.ndarray:
    """Pack a bit array (MSB first per symbol) into constellation symbols —
    numpy helper for transmitters/tests."""
    bps = bits_per_symbol(ms)
    bits = np.asarray(bits).reshape(-1, bps)
    idx = np.zeros(len(bits), dtype=np.int64)
    for b in range(bps):
        idx = (idx << 1) | bits[:, b]
    return constellation(ms)[idx].astype(np.complex64)


def _metric_panel(y, ms: str):
    """(n, M) panel of −|y−c|²/const = Re(y·c̄) − |c|²/2 (maximize)."""
    C = constellation(ms).astype(np.complex64)
    cr = jnp_const(np.ascontiguousarray(C.real).astype(np.float32))
    ci = jnp_const(np.ascontiguousarray(C.imag).astype(np.float32))
    half_e = jnp_const((np.abs(C) ** 2 / 2.0).astype(np.float32))
    yr = jnp.real(y)[:, None]
    yi = jnp.imag(y)[:, None]
    return yr * cr[None, :] + yi * ci[None, :] - half_e[None, :]


def hard_decision(y, ms: str):
    """Nearest-point decisions: returns (indices int32 (n,), symbols
    complex64 (n,)).  The index IS the gray-mapped bit pattern."""
    m = _metric_panel(y, ms)
    idx = jnp.argmax(m, axis=-1).astype(jnp.int32)
    C = constellation(ms).astype(np.complex64)
    # lax.complex, not "re + 1j*im": gathers from the real and imaginary
    # planes directly (this helper is documented as usable standalone)
    sym = jax.lax.complex(jnp_const(np.ascontiguousarray(C.real))[idx],
                          jnp_const(np.ascontiguousarray(C.imag))[idx])
    return idx, sym.astype(jnp.complex64)


def soft_llrs(y, ms: str, noise_var: float = 0.1):
    """Max-log LLRs, (n, bps) float32, MSB first.  Positive ⇒ bit 0.

    LLR_b = (min_{c: bit_b=1}|y−c|² − min_{c: bit_b=0}|y−c|²) / N₀.
    """
    bps = bits_per_symbol(ms)
    M = 1 << bps
    m = _metric_panel(y, ms)  # maximize ⇔ minimize |y−c|²
    cols = []
    for b in range(bps):
        bit = (np.arange(M) >> (bps - 1 - b)) & 1
        mask0 = jnp_const(np.where(bit == 0, 0.0, -np.inf).astype(np.float32))
        mask1 = jnp_const(np.where(bit == 1, 0.0, -np.inf).astype(np.float32))
        m0 = jnp.max(m + mask0[None, :], axis=-1)
        m1 = jnp.max(m + mask1[None, :], axis=-1)
        # |y−c|² = |y|² − 2·metric + const; the |y|²/const cancel in the diff
        cols.append(2.0 * (m0 - m1) / np.float32(noise_var))
    return jnp.stack(cols, axis=-1)


def symbols_to_bits(idx: np.ndarray, ms: str) -> np.ndarray:
    """Decision indices → bit array (n·bps,), MSB first."""
    bps = bits_per_symbol(ms)
    idx = np.asarray(idx, dtype=np.int64)
    out = np.empty((len(idx), bps), dtype=np.int64)
    for b in range(bps):
        out[:, b] = (idx >> (bps - 1 - b)) & 1
    return out.reshape(-1)


class SoftDecision(Block):
    """Stateless block mapping tracked symbols → (n, bps) max-log LLRs."""

    stateless = True

    def __init__(self, ms: str, noise_var: float = 0.1):
        self.ms = ms
        self.noise_var = noise_var
        self.name = f"soft_{ms}"

    def apply(self, state, y):
        return state, soft_llrs(y, self.ms, self.noise_var)


def soft_decision(ms: str, noise_var: float = 0.1) -> Block:
    return SoftDecision(ms, noise_var)


# ---- coded packet loopback (round 5: ops/fec.py joined to the modem) ----

_PREAMBLE_BITS = 64  # 0101... sync/AGC run before the coded payload


def coded_packet_modulate(payload_bits, ms: str = "qpsk",
                          polys=None, K: int = 7):
    """Payload bits → preamble + length word + conv-coded symbols — the
    transmit side of a complete FEC-protected packet link over any
    constellation in CONSTELLATIONS (`coded_packet_demodulate` inverts
    it; tests run the pair through AWGN + phase offset)."""
    from ..ops import fec

    if polys is None:
        polys = fec.CCSDS_POLYS
    payload_bits = np.asarray(payload_bits, np.int64) & 1
    n = len(payload_bits)
    if n > 0xFFFF:
        raise ValueError(
            f"payload {n} bits exceeds the 16-bit length word (65535)")
    length = [(n >> (15 - i)) & 1 for i in range(16)]
    frame = np.concatenate([length, payload_bits])
    coded = fec.conv_encode(frame, tuple(polys), K)
    pre = np.tile([0, 1], _PREAMBLE_BITS // 2)
    bits = np.concatenate([pre, coded])
    bps = bits_per_symbol(ms)
    if len(bits) % bps:
        bits = np.concatenate([bits, np.zeros(bps - len(bits) % bps,
                                              np.int64)])
    return modulate(bits, ms)


def coded_packet_demodulate(symbols, ms: str = "qpsk", noise_var: float = 0.1,
                            polys=None, K: int = 7):
    """Tracked symbols (timing/carrier recovered — e.g. `sym_tracker`
    output) → decoded payload bits or None.  Soft LLRs feed the Viterbi
    directly; the 16-bit length word delimits the payload."""
    from ..ops import fec

    if polys is None:
        polys = fec.CCSDS_POLYS
    bps = bits_per_symbol(ms)
    llr = np.asarray(soft_llrs(symbols, ms, noise_var)).reshape(-1)
    G = len(polys)
    body = llr[_PREAMBLE_BITS:]
    body = body[: (len(body) // G) * G]
    dec = np.asarray(fec.viterbi_decode(body, tuple(polys), K))
    if len(dec) < 16:
        return None
    n = int("".join(str(int(b)) for b in dec[:16]), 2)
    if n < 0 or 16 + n > len(dec):
        return None
    return dec[16:16 + n]
