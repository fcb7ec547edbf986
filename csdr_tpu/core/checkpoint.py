"""Checkpoint / resume for streaming pipelines.

The reference has NO checkpointing — all DSP state lives in opaque liquid C
objects and dies with the process (SURVEY.md §5).  Here every block's state is
an explicit pytree, so a checkpoint is just (state pytree, stream position,
graph signature).  An hour-long 64-channel job can resume mid-stream with
bit-identical continuation (verified in tests/test_checkpoint.py).

Format: a single .npz with flattened leaves + a JSON treedef/metadata entry —
no extra dependencies, deterministic, and portable across hosts.
"""

from __future__ import annotations

import json

import numpy as np
import jax

from .runtime import to_host, to_device

__all__ = ["save_state", "load_state", "save_pipeline", "resume_pipeline"]

_META_KEY = "__csdr_meta__"


def _norm_path(path: str) -> str:
    """np.savez always appends '.npz' to extension-less paths; normalize so
    save('job.ckpt') and load('job.ckpt') agree."""
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state, *, position: int = 0, signature: str = ""):
    leaves, treedef = jax.tree.flatten(state)
    arrays = {f"leaf_{i}": to_host(x) for i, x in enumerate(leaves)}
    meta = dict(position=position, signature=signature, n_leaves=len(leaves),
                treedef=str(treedef))
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(_norm_path(path), **arrays)


def load_state(path: str, like_state, *, signature: str = ""):
    """Load a checkpoint into the structure of ``like_state`` (usually
    block.init()).  Returns (state, position).  Raises on signature or
    structure mismatch."""
    with np.load(_norm_path(path)) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        leaves, treedef = jax.tree.flatten(like_state)
        if meta["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, graph has {len(leaves)}")
        if signature and meta["signature"] and meta["signature"] != signature:
            raise ValueError(
                f"checkpoint signature {meta['signature']!r} != graph {signature!r}")
        new_leaves = []
        for i, ref in enumerate(leaves):
            arr = z[f"leaf_{i}"]
            # validate against .shape/.dtype attributes — NO np.asarray(ref):
            # materializing a device leaf to host would copy it just to
            # read its metadata
            ref_shape = tuple(getattr(ref, "shape", np.shape(ref)))
            ref_dtype = np.dtype(getattr(ref, "dtype", np.asarray(ref).dtype))
            if arr.shape != ref_shape or arr.dtype != ref_dtype:
                raise ValueError(f"leaf {i}: {arr.shape}/{arr.dtype} != "
                                 f"{ref_shape}/{ref_dtype}")
            new_leaves.append(to_device(arr))
        return jax.tree.unflatten(treedef, new_leaves), meta["position"]


def save_pipeline(path: str, pipeline, position: int):
    """Checkpoint a core.runtime.Pipeline mid-stream."""
    save_state(path, pipeline.state, position=position,
               signature=pipeline.block.name)


def resume_pipeline(path: str, pipeline) -> int:
    """Restore a Pipeline's state; returns the stream position (input samples
    already consumed) so the caller can seek its source."""
    # pipelines hold encoded state; the Pipeline's jitted init gives the
    # encoded structure to validate against
    like = pipeline._init()
    state, position = load_state(path, like, signature=pipeline.block.name)
    pipeline.state = jax.tree.map(lambda x: x, state)
    return position
