"""GMSK demodulator block.

Reference: gmskDemodulator m k bw wrapping liquid gmskdem — k samples in per
1-bit symbol out, per-symbol C call loop
(/root/reference/src/ComposableSDR/Liquid.chs:384-429; throws unless the block
is divisible by k, :421 — our granule mechanism enforces the same statically).

Structure: FM discriminator (elementwise) → GMSK receive matched filter
(ops/fir) → strided symbol sampling at the matched-filter peak → sign slicer.
No per-symbol loop.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import jax.numpy as jnp

from ..core.block import Block
from ..ops.demod import freqdem_stream
from ..ops.fir import fir_stream
from ..utils import firdes

__all__ = ["GMSKDemod", "gmsk_demodulator", "gmsk_mod"]


class GMSKDemod(Block):
    def __init__(self, m: int, k: int, bw: float = 0.3):
        self.m, self.k, self.bw = m, k, bw
        self.taps = firdes.gmsk_rx(k, m, bw)
        self.rate = Fraction(1, k)
        self.granule = k
        self.name = f"gmsk_demod(m={m},k={k})"
        # symbols assumed block-aligned (liquid requires the same,
        # Liquid.chs:421); tx pulse delay (m·k) + matched-filter delay (m·k)
        # ≡ 0 (mod k), so centers sit at stride offsets 0
        self.offset = (2 * m * k) % k

    def init(self):
        return (jnp.ones((1,), jnp.complex64),
                jnp.zeros((len(self.taps) - 1,), jnp.float32))

    def apply(self, state, x):
        last, hist = state
        kf = 0.25 / self.k  # ±π/(2k) per-sample deviation → ±1 levels
        last, d = freqdem_stream(last, x, kf)
        hist, y = fir_stream(self.taps, hist, d)
        sym = y[self.offset::self.k]
        bits = (sym > 0).astype(jnp.uint32)
        return (last, hist), bits

    def shard_apply(self, state, x, ctx):
        """Time-sharded demod: both carried tails (demod's previous sample,
        matched-filter history) come from the left neighbor; the symbol
        stride stays aligned because every local segment is a multiple of k."""
        last, hist = state
        kf = 0.25 / self.k
        prev = ctx.left_halo(x, last, 1)
        _, d = freqdem_stream(prev, x, kf)
        new_last = ctx.from_last_time(x[-1:])
        new_hist, y = ctx.fir(self.taps, hist, d)
        sym = y[self.offset::self.k]
        bits = (sym > 0).astype(jnp.uint32)
        return (new_last, new_hist), bits

    def shard_validate(self, nloc, ctx):
        if nloc % self.granule:
            raise ValueError(f"{self.name}: local segment {nloc} not a "
                             f"multiple of k={self.k}")
        if nloc < len(self.taps) - 1:
            raise ValueError(f"{self.name}: local segment {nloc} shorter than "
                             f"the matched-filter halo {len(self.taps) - 1}")
        return nloc // self.k


def gmsk_demodulator(m: int, k: int, bw: float = 0.3) -> Block:
    return GMSKDemod(m, k, bw)


def gmsk_mod(bits: np.ndarray, k: int, m: int, bw: float = 0.3) -> np.ndarray:
    """Test oracle: GMSK modulator (Gaussian-filtered MSK, h = 0.5)."""
    a = np.asarray(bits, dtype=np.float64) * 2.0 - 1.0
    g = firdes.gmsk_tx(k, m, bw)  # sums to 1 over one symbol
    up = np.zeros(len(a) * k)
    up[::k] = a
    inst = np.convolve(up, g)[: len(a) * k]
    phase = np.pi / 2.0 * np.cumsum(inst)
    return np.exp(1j * phase).astype(np.complex64)
