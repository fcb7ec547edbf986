"""Convolutional FEC: encoder + a block-parallel soft-decision Viterbi decoder.

Capability extension beyond the reference (liquid-dsp bundles libfec's
scalar-loop Viterbi; the reference never exposes it): the decode trellis
here is a `lax.scan` over time whose per-step work is fully vectorized over
the 2^(K-1) states — one add-compare-select across all states per symbol
in vectorized (S,) panels, decisions stored as a (T, S) plane and traced
back with a second scan.  No per-sample Python, no data-dependent shapes;
jit/vmap/shard-compatible like every other op in `ops/`.

Default code: the ubiquitous K=7, rate-1/2 (171, 133)₈ pair (CCSDS /
"Voyager" polynomials), the workhorse of amateur packet FEC.  Any K ≤ 16
and any number of generator polynomials work; the trellis tables are built
host-side in numpy once per (K, polys) and closed over as constants.

Conventions: polynomials are given in octal-style integers whose bit i
taps register delay i (bit 0 = the newest input bit).  ``tail=True``
appends K−1 zero flush bits to the message — the decoder then starts and
ends in state 0, which is also what the BER tests assume.  Soft inputs are
LLRs with the `models/modem.soft_llrs` convention (positive = bit 0).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["CCSDS_POLYS", "conv_encode", "viterbi_decode", "coded_ber"]

CCSDS_POLYS = (0o171, 0o133)   # K=7 rate-1/2


def _parity(v: np.ndarray) -> np.ndarray:
    p = np.zeros_like(v)
    while np.any(v):
        p ^= v & 1
        v >>= 1
    return p


@functools.lru_cache(maxsize=None)
def _tables(polys: tuple, K: int):
    """Trellis constants: for each next-state ns its two predecessor states
    and, per generator, the output bits of those transitions."""
    S = 1 << (K - 1)
    s = np.arange(S)
    # register for (state s, input b) = (s << 1) | b — the input is the
    # newest (delay 0) bit, the state holds the previous K-1 bits
    out = np.zeros((2, len(polys), S), np.int8)
    nxt = np.zeros((2, S), np.int64)
    for b in (0, 1):
        r = (s << 1 | b)
        nxt[b] = r & (S - 1)      # next state keeps the newest K-1 bits
        for gi, g in enumerate(polys):
            out[b, gi] = _parity((r & g).astype(np.int64))
    # predecessors of ns: the two states s with nxt[b, s] == ns; from
    # nxt = (s<<1|b) & (S-1): s = (ns >> 1) | (h << (K-2)) for h ∈ {0,1},
    # with input bit b = ns & 1
    ns = np.arange(S)
    prev = np.stack([(ns >> 1), (ns >> 1) | (1 << (K - 2))])   # (2, S)
    bit_in = ns & 1                                            # (S,)
    # output bits of the two incoming branches, per generator: (2, G, S)
    branch_out = np.stack([out[bit_in, :, prev[h]].T for h in (0, 1)])
    return S, prev, bit_in, branch_out


def conv_encode(bits: np.ndarray, polys: tuple = CCSDS_POLYS, K: int = 7,
                tail: bool = True) -> np.ndarray:
    """Message bits → coded bits, generator-interleaved
    (g0(t0), g1(t0), g0(t1), …).  Pure numpy (test/encoder side)."""
    b = np.asarray(bits, np.int64) & 1
    if tail:
        b = np.concatenate([b, np.zeros(K - 1, np.int64)])
    reg = 0
    out = np.zeros((len(b), len(polys)), np.int8)
    for t, bit in enumerate(b):
        reg = ((reg << 1) | int(bit)) & ((1 << K) - 1)
        for gi, g in enumerate(polys):
            out[t, gi] = bin(reg & g).count("1") & 1
    return out.reshape(-1)


def viterbi_decode(llrs, polys: tuple = CCSDS_POLYS, K: int = 7,
                   tail: bool = True):
    """Soft-decision Viterbi: LLRs (n_sym · n_gen,) generator-interleaved
    (positive = bit 0) → decoded message bits (n_sym − (K−1) if ``tail``).

    jit-compatible; runs the ACS recursion as `lax.scan` over symbols with
    all 2^(K-1) states updated as one vector op per step."""
    S, prev_np, bit_in_np, branch_out_np = _tables(tuple(polys), K)
    G = len(polys)
    llrs = jnp.asarray(llrs, jnp.float32).reshape(-1, G)      # (T, G)
    prev = jnp.asarray(prev_np)                                # (2, S)
    # per-branch sign panel: out bit 1 ⇒ metric −llr, out 0 ⇒ +llr
    sign = jnp.asarray(1.0 - 2.0 * branch_out_np, jnp.float32)  # (2, G, S)
    neg = jnp.float32(-1e9)
    m0 = jnp.full((S,), neg).at[0].set(0.0)    # tail ⇒ start in state 0

    def acs(metric, llr_t):
        # branch metrics of the two incoming edges of every next-state
        bm = jnp.einsum("g,hgs->hs", llr_t, sign)              # (2, S)
        cand = metric[prev] + bm                               # (2, S)
        decision = jnp.argmax(cand, axis=0)                    # (S,)
        new = jnp.max(cand, axis=0)
        new = new - jnp.max(new)                               # re-normalize
        return new, decision.astype(jnp.uint8)

    metric, decisions = jax.lax.scan(acs, m0, llrs)            # (T, S)

    end = jnp.int32(0) if tail else jnp.argmax(metric).astype(jnp.int32)
    bit_in = jnp.asarray(bit_in_np)

    def back(state, dec_t):
        b = bit_in[state]
        state = prev[dec_t[state], state]
        return state, b

    _, bits_rev = jax.lax.scan(back, end, decisions, reverse=True)
    # reverse=True scans from the end but emits in FORWARD order already
    bits = bits_rev.astype(jnp.uint8)
    return bits[: bits.shape[0] - (K - 1)] if tail else bits


def coded_ber(n_bits: int, snr_db: float, seed: int = 0,
              polys: tuple = CCSDS_POLYS, K: int = 7):
    """BPSK-over-AWGN loopback at ``snr_db`` (Es/N0 of the CODED symbols):
    returns (coded BER, uncoded BER at the same channel SNR) — the
    coding-gain measurement the tests pin."""
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, n_bits)
    coded = conv_encode(msg, polys, K)
    es = 10.0 ** (snr_db / 10.0)
    sigma = np.sqrt(1.0 / (2.0 * es))
    tx = 1.0 - 2.0 * coded.astype(np.float64)
    rx = tx + sigma * rng.normal(size=len(tx))
    llr = (2.0 / sigma ** 2) * rx                 # positive = bit 0
    dec = np.asarray(viterbi_decode(llr, polys, K))
    ber = float(np.mean(dec != msg))
    ber_uncoded = float(np.mean((rx < 0).astype(np.int8) != coded))
    return ber, ber_uncoded
