"""ShardedChain — run ANY Block graph on a device mesh.

This is the generic multi-chip path: where parallel/channelized.py hand-fuses
one flagship graph, ShardedChain takes an arbitrary Block (usually a Chain),
validates it statically against the mesh (halo sizes, granule divisibility,
channel-axis divisibility), and wraps its ``shard_apply`` in one
``jax.shard_map`` + ``jit`` step:

  * input: a 1-D sample block sharded P(time) — each device owns a contiguous
    time segment;
  * carried state: replicated (P()); every block's state update funnels
    through ShardCtx.from_last_time so streaming across successive global
    blocks is exact on any mesh shape;
  * output: P(time) for 1-D streams, P(ch, time) for channelized (nch, F)
    panels — the layout is derived by propagating each block's
    ``shard_layout`` through the graph;
  * the whole jit boundary is complex-free (core/runtime.CEnc), like the
    serial Pipeline.

The reference's defining property — any composition of Pipes works
(/root/reference/src/ComposableSDR/Types.hs:93-103) — holds here one level
up: any composition shards.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.block import Block
from ..core.sharding import ShardCtx, TIME, CH
from ..core.runtime import CEnc, encode_tree, decode_tree, _encode_host

__all__ = ["ShardedChain"]


class ShardedChain:
    """Sharded streaming executor for an arbitrary Block graph.

    Same step interface as parallel/channelized.ShardedChannelizedFM:
    ``init() -> state`` (CEnc-encoded, replicated), ``step(state, x) ->
    (state, y)`` with x a (block_size,) host/device array.
    """

    def __init__(self, block: Block, mesh: Mesh, block_size: int,
                 time_axis: str = "time", ch_axis: str = "ch",
                 out_layout=None):
        self.block = block
        self.mesh = mesh
        self.time_axis = time_axis
        self.ch_axis = ch_axis
        axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        self.dt = axis_sizes[time_axis]
        self.dc = axis_sizes.get(ch_axis, 1)
        g = block.granule
        if block_size % (self.dt * g):
            raise ValueError(f"block_size {block_size} must be a multiple of "
                             f"time_shards·granule = {self.dt}·{g}")
        self.block_size = block_size
        self.nloc = block_size // self.dt
        self.rate: Fraction = block.rate

        # static validation + final layout (no jnp ops)
        vctx = self._make_ctx()
        self.nloc_out = block.shard_validate(self.nloc, vctx)
        self.out_layout = out_layout if out_layout is not None \
            else block.shard_layout(TIME)

        out_specs = jax.tree.map(self._layout_spec, self.out_layout,
                                 is_leaf=lambda l: isinstance(l, str))

        # per-leaf state placement: "ch"-tagged leaves (PerChannel stacks)
        # stay sharded over the channel mesh axis instead of replicated —
        # no O(nch·state) all-gather per step (Block.shard_state_spec)
        state_tags = block.shard_state_spec(vctx)
        spec_of = lambda tag: (P(ch_axis) if tag == "ch" and self.dc > 1
                               else P())
        state_specs = jax.tree.map(spec_of, state_tags)

        def local_step(state, x):
            ctx = self._make_ctx()
            ctx.state_local = True
            return block.shard_apply(state, x, ctx)

        self._shmap = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(state_specs, P(time_axis)),
            out_specs=(state_specs, out_specs),
            check_vma=False,
        )

        def _enc_step(state_enc, x_enc):
            s, x = decode_tree(state_enc), decode_tree(x_enc)
            s2, y = self._shmap(s, x)
            return encode_tree(s2), encode_tree(y)

        self._step = jax.jit(_enc_step, donate_argnums=(0,))
        # shard_init, not init: Chains collapse fused halo runs into one
        # raw-input tail per run (core/block.Chain._shard_segments); the
        # encoded init output is PLACED per state_specs (CEnc wraps complex
        # leaves as (…, 2) float planes — leading-axis specs survive that)
        enc_template = jax.eval_shape(lambda: block.shard_init())
        enc_shardings = jax.tree.map(
            lambda leaf, tag: (CEnc(NamedSharding(mesh, spec_of(tag)))
                               if jnp.issubdtype(leaf.dtype, jnp.complexfloating)
                               else NamedSharding(mesh, spec_of(tag))),
            enc_template, state_tags)
        self._init = jax.jit(lambda: encode_tree(block.shard_init()),
                             out_shardings=enc_shardings)

    def _make_ctx(self) -> ShardCtx:
        return ShardCtx(self.dt, self.dc, self.time_axis, self.ch_axis, TIME)

    def _layout_spec(self, layout: str):
        if layout == CH:
            return P(self.ch_axis, self.time_axis) if self.dc > 1 \
                else P(None, self.time_axis)
        return P(self.time_axis)

    # ---- public API --------------------------------------------------------
    def init(self):
        return self._init()

    def input_sharding(self):
        return NamedSharding(self.mesh, P(self.time_axis))

    def step(self, state, x):
        """x: (block_size,) array (complex allowed; encoded internally).
        Returns (new_state, y) with y still CEnc-encoded on device."""
        return self._step(state, _encode_host(x))
