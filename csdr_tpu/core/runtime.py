"""Streaming runtime: host feed/drain loop around one jitted graph step.

Reference equivalent: the Streamly fold driver `runFold = S.fold fdl (prep src)`
(/root/reference/apps/SoapySDR.hs:235) plus the re-blocking combinators
`compact` and `takeNArr` (Trans.hs:33-84).  Differences by design:

  * blocks are LARGE (default 2^20 samples) so each device step amortises
    dispatch and fills the accelerator;
  * the graph step is one jit-compiled function with donated state (no
    per-block allocation churn);
  * re-blocking ("compact") and the exact-N trim ("takeNArr") happen host-side
    in the feeder, where the reference did them as stream combinators;
  * double-buffering: the next input block is transferred to the device while
    the current one computes (dispatch is async in JAX).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .block import Block

__all__ = ["Pipeline", "rechunk", "take_n", "skip_n", "to_host", "to_device",
           "CEnc", "encode_tree", "decode_tree", "decode_tree_host"]

DEFAULT_BLOCK = 1 << 20


@jax.jit
def _split_complex(a):
    return jnp.stack([jnp.real(a), jnp.imag(a)], axis=-1)


@jax.jit
def _join_complex(f):
    return jax.lax.complex(f[..., 0], f[..., 1])


def to_host(a) -> np.ndarray:
    """Device→host transfer that moves complex64 as float32 (re, im) pairs.

    Complex arrays are split on device and recombined host-side, the same
    complex-free encoding as CEnc (the first accelerator backend could not
    transfer complex64; whether the split still earns its place on the GPU
    is an open design debt).
    """
    if isinstance(a, np.ndarray):
        return a
    if jnp.iscomplexobj(a):
        f = np.asarray(_split_complex(a))
        return (f[..., 0] + 1j * f[..., 1]).astype(np.complex64)
    return np.asarray(a)


def to_device(x, device=None):
    """Host→device transfer with the same complex64 split (see to_host).
    ``device`` pins placement (default device when None)."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        f = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
        fd = jnp.asarray(f) if device is None else jax.device_put(f, device)
        return _join_complex(fd)
    return jnp.asarray(x) if device is None else jax.device_put(x, device)


class CEnc(NamedTuple):
    """Marker node: a complex array encoded as float32 (…, 2) re/im planes.

    The Pipeline keeps its whole jit boundary complex-free: complex
    state/input/output leaves cross as CEnc-wrapped float planes and are
    joined/split *inside* the program.  The encoding dates from a backend that
    could not pass complex arrays across the jit boundary; the GPU can, so
    it is kept only until its removal is measured.
    """

    ri: object


def encode_tree(t):
    """Complex leaves → CEnc(float32 (…, 2)).  Works on traced or concrete
    pytrees."""
    return jax.tree.map(
        lambda l: CEnc(jnp.stack([jnp.real(l), jnp.imag(l)], axis=-1))
        if jnp.iscomplexobj(l) else l, t)


def decode_tree(t):
    """Inverse of encode_tree (device-side join for CEnc leaves)."""
    return jax.tree.map(
        lambda l: jax.lax.complex(l.ri[..., 0], l.ri[..., 1])
        if isinstance(l, CEnc) else l,
        t, is_leaf=lambda l: isinstance(l, CEnc))


def decode_tree_host(t):
    """Host-side decode: CEnc leaves → numpy complex64 (no device ops)."""
    def dec(l):
        if isinstance(l, CEnc):
            f = np.asarray(l.ri)
            return (f[..., 0] + 1j * f[..., 1]).astype(np.complex64)
        return np.asarray(l)
    return jax.tree.map(dec, t, is_leaf=lambda l: isinstance(l, CEnc))


def _encode_host(x):
    """Host (or device) array → encoded jit argument (never complex)."""
    if isinstance(x, CEnc):
        return x
    if isinstance(x, np.ndarray):
        if np.iscomplexobj(x):
            f = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
            return CEnc(jnp.asarray(f))
        return jnp.asarray(x)
    if jnp.iscomplexobj(x):
        return CEnc(jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1))
    return x


def rechunk(chunks: Iterable[np.ndarray], size: int) -> Iterator[np.ndarray]:
    """Re-block a stream of arbitrary-size arrays into exact ``size`` arrays
    (final short remainder is emitted as-is).  Host-side `compact`
    (reference Trans.hs:58-84)."""
    buf: list[np.ndarray] = []
    have = 0
    for c in chunks:
        c = np.asarray(c)
        while True:
            if have + len(c) < size:
                if len(c):
                    buf.append(c)
                    have += len(c)
                break
            need = size - have
            buf.append(c[:need])
            out = np.concatenate(buf) if len(buf) > 1 else buf[0]
            yield out
            buf, have = [], 0
            c = c[need:]
    if have:
        yield np.concatenate(buf) if len(buf) > 1 else buf[0]


def append_flush(chunks: Iterable[np.ndarray], nflush: int) -> Iterator[np.ndarray]:
    """Append the graph's end-of-stream zero-fill allowance (Block.flush_len)
    after the source is exhausted, matching the last chunk's dtype/row shape.
    The fill counts as ordinary valid input, so the rational-rate trim emits
    exactly the withheld samples (reference fold `done`, Trans.hs:86-104).
    An empty source flushes nothing (there is nothing withheld)."""
    tail_shape: tuple = ()
    dtype = None
    for c in chunks:
        c = np.asarray(c)
        tail_shape, dtype = c.shape[1:], c.dtype
        yield c
    if nflush and dtype is not None:
        yield np.zeros((nflush,) + tail_shape, dtype)


def take_n(chunks: Iterable[np.ndarray], n: int) -> Iterator[np.ndarray]:
    """Trim a chunk stream to exactly n samples (reference takeNArr,
    Trans.hs:33-56)."""
    got = 0
    for c in chunks:
        if got + len(c) >= n:
            yield np.asarray(c)[: n - got]
            return
        got += len(c)
        yield c


def skip_n(chunks: Iterable[np.ndarray], n: int) -> Iterator[np.ndarray]:
    """Drop the first n samples of a chunk stream — the source-seek companion
    of checkpoint resume: ``resume_pipeline`` returns the consumed position;
    ``skip_n(source, position)`` realigns any chunk iterator to it."""
    dropped = 0
    it = iter(chunks)
    for c in it:
        if dropped + len(c) <= n:
            dropped += len(c)
            continue
        yield np.asarray(c)[n - dropped:]
        break
    yield from it


class Pipeline:
    """Jit-compiled streaming executor for a Block graph.

    The jitted step's arguments and results are kept complex-free (CEnc
    encoding); block.apply itself runs on ordinary complex arrays."""

    def __init__(self, block: Block, block_size: int = DEFAULT_BLOCK,
                 donate: bool = True, device=None, profile: bool = False):
        g = block.granule
        self.block = block
        self.block_size = max(g, (block_size // g) * g)
        self.device = device
        self.profile = profile
        self.stage_stats: list = []

        def step(s_enc, x_enc):
            s, x = decode_tree(s_enc), decode_tree(x_enc)
            s2, y = block.apply(s, x)
            return encode_tree(s2), encode_tree(y)

        if profile:
            # per-block profiling (SURVEY.md §5: the counter the reference
            # lacks): each stage compiles to its own jit with a CEnc-encoded
            # boundary; process_block barriers between stages and meters
            # each.  The whole-graph fusion across stage boundaries is lost
            # while profiling — this is an observability mode, the budget
            # shares are what it is for, not peak absolute throughput.
            from .block import Chain as _Chain
            from ..utils.prof import StageStat

            self._stage_split = isinstance(block, _Chain)
            self._stages = (list(block.blocks) if self._stage_split
                            else [block])

            def mk(b):
                def stp(s_enc, x_enc):
                    s, x = decode_tree(s_enc), decode_tree(x_enc)
                    s2, y = b.apply(s, x)
                    return encode_tree(s2), encode_tree(y)
                return jax.jit(stp, donate_argnums=(0,) if donate else ())

            self._stage_steps = [mk(b) for b in self._stages]
            rates, acc = [], Fraction(1)
            for b in self._stages:
                rates.append(acc)
                acc *= b.rate
            self._stage_in_rate = rates
            self.stage_stats = [StageStat(b.name or type(b).__name__)
                                for b in self._stages]
        else:
            self._step = jax.jit(step, donate_argnums=(0,) if donate else ())
        # init+encode run as one jitted program, so the initial state is
        # created on the device already encoded
        self._init = jax.jit(lambda: encode_tree(block.init()))
        self.state = self._place(self._init())

    def _place(self, tree):
        return tree if self.device is None else jax.device_put(tree, self.device)

    def reset(self):
        self.state = self._place(self._init())

    def process_block(self, x):
        """x: numpy or device array (complex allowed — encoded internally).
        Returns the ENCODED output pytree (CEnc re/im planes for complex
        leaves) — pass it through ``decode_tree_host`` for numpy complex;
        ``run``/``stream`` do that for you."""
        x_enc = self._place(_encode_host(x))
        if not self.profile:
            self.state, y_enc = self._step(self.state, x_enc)
            return y_enc
        return self._process_profiled(x_enc)

    def _process_profiled(self, x_enc):
        """Profiled step: stages run as separate jits with a barrier and a
        wall-clock meter around each.  Data stays device-resident between
        stages (encoded trees); the input-sample count per stage follows the
        accumulated rational rate so per-stage MSPS are on each stage's own
        basis."""
        import time

        first = jax.tree.leaves(x_enc, is_leaf=lambda l: isinstance(l, CEnc))[0]
        n_in = (first.ri.shape[0] if isinstance(first, CEnc) else first.shape[0])
        states = list(self.state) if self._stage_split else [self.state]
        y = x_enc
        jax.block_until_ready(jax.tree.leaves((states, y)))
        for i, stp in enumerate(self._stage_steps):
            t0 = time.perf_counter()
            states[i], y = stp(states[i], y)
            jax.block_until_ready(jax.tree.leaves((states[i], y)))
            r = self._stage_in_rate[i]
            self.stage_stats[i].add(time.perf_counter() - t0,
                                    n_in * r.numerator // r.denominator)
        self.state = tuple(states) if self._stage_split else states[0]
        return y

    def profile_report(self) -> str:
        """Per-stage budget table (Pipeline(profile=True) runs only)."""
        from ..utils.prof import stage_table

        if not self.stage_stats:
            return "(profiling disabled — construct Pipeline(profile=True))"
        return stage_table(self.stage_stats)

    def stream(self, source: Iterable[np.ndarray],
               num_samples: int | None = None,
               flush: bool = False) -> Iterator[np.ndarray]:
        """Generator form of run(): yields trimmed numpy output blocks.  Used
        to chain pipelines host-side (the reference materializes its front-end
        Pipe the same way via unPipe, Types.hs:109-115).  ``flush`` defaults
        OFF here: when pipelines are chained host-side, only the terminal
        consumer should flush (run() defaults it on)."""
        n = self.block_size
        it: Iterable[np.ndarray] = source
        if num_samples is not None:
            it = take_n(it, num_samples)
        if flush:
            nflush = self.block.flush_len()
            if nflush:
                it = append_flush(it, nflush)
        rt = self.block.rate_tree()
        for chunk in rechunk(it, n):
            valid = len(chunk)
            if valid < n:
                chunk = np.pad(chunk, [(0, n - valid)] + [(0, 0)] * (chunk.ndim - 1))
            y_enc = self.process_block(chunk)
            # tree-aware trim: tuple outputs (Tee/Delay graphs) trim per
            # leaf, each by its own rational rate (multi-rate Tee)
            out, _ = _trim_tree(decode_tree_host(y_enc), rt, valid)
            yield out

    def run(self, source: Iterable[np.ndarray], sink: Callable[[np.ndarray], None],
            num_samples: int | None = None, progress: Callable | None = None,
            checkpoint_path: str | None = None, checkpoint_every: int = 0,
            flush: bool = True):
        """Stream source → graph → sink.  Returns total output samples.

        The final short block is zero-padded to the full static block size
        (shapes stay static under jit) and its outputs trimmed to the exact
        rational-rate sample count — this preserves the reference's exact
        sample accounting (README.md:191-192 byte-count invariant).

        ``flush`` (default on): after the source ends, feed the graph's
        flush allowance (Block.flush_len) of zero samples so blocks that
        withhold data (Delay, the stereo decoder's group-delay line) emit
        their final samples — the reference fold's `done` semantics
        (Trans.hs:86-104).  A no-op (zero allowance) for ordinary graphs.

        ``checkpoint_path`` + ``checkpoint_every`` (input samples): write a
        resumable state checkpoint periodically (core/checkpoint.py) — the
        subsystem the reference entirely lacks (SURVEY.md §5).
        """
        n = self.block_size
        it: Iterable[np.ndarray] = source
        if num_samples is not None:
            it = take_n(it, num_samples)
        if flush:
            nflush = self.block.flush_len()
            if nflush:
                it = append_flush(it, nflush)
        total_out = 0
        total_in = 0
        last_ckpt = 0
        rt = self.block.rate_tree()
        pending = None  # (device result, valid_in) — drain one step late to
        # overlap host IO with device compute
        for chunk in rechunk(it, n):
            valid = len(chunk)
            if valid < n:
                chunk = np.pad(chunk, [(0, n - valid)] + [(0, 0)] * (chunk.ndim - 1))
            y = self.process_block(chunk)
            if pending is not None:
                total_out += _drain(pending[0], pending[1], rt, sink)
            pending = (y, valid)
            total_in += valid
            if progress is not None:
                progress(valid)
            if (checkpoint_path and checkpoint_every
                    and total_in - last_ckpt >= checkpoint_every):
                from .checkpoint import save_pipeline

                # drain the pending block FIRST: the checkpoint's position
                # covers it, so its output must be in the sink before the
                # state is durable — otherwise a crash between save and the
                # next drain loses one block of sink output on resume
                if pending is not None:
                    total_out += _drain(pending[0], pending[1], rt, sink)
                    pending = None
                save_pipeline(checkpoint_path, self, position=total_in)
                last_ckpt = total_in
        if pending is not None:
            total_out += _drain(pending[0], pending[1], rt, sink)
        return total_out


def _trim_tree(arr, rt, valid_in: int):
    """Trim each output leaf to its own rational-rate sample count (along
    the last axis for channelized (nch, n) leaves, leading axis otherwise).
    ``rt`` is a Fraction (broadcast over all leaves — same-rate tuples like
    Delay) or a tuple mirroring the output structure (multi-rate Tee).
    Returns (trimmed, primary_count) — the first leaf's count, used for
    sample accounting."""
    if isinstance(rt, Fraction):
        k = (valid_in * rt.numerator) // rt.denominator

        def trim(a):
            if a.ndim >= 2:
                return a[..., :k]
            return a[:k]
        return jax.tree.map(trim, arr), k
    trimmed = []
    k0 = None
    for a, r in zip(arr, rt):
        t, k = _trim_tree(a, r, valid_in)
        trimmed.append(t)
        if k0 is None:
            k0 = k
    return tuple(trimmed), k0


def _drain(y_enc, valid_in: int, rt, sink: Callable[[np.ndarray], None]) -> int:
    """Decode + per-leaf trim (see _trim_tree) and hand to sink."""
    out, k = _trim_tree(decode_tree_host(y_enc), rt, valid_in)
    sink(out)
    return k
