"""Device-safe constant materialization.

Large traced constants are hoisted by jax into runtime parameters, so a
complex numpy constant (DFT matrix, FFT'd tap vector, tone table) closed over
by a jitted function becomes a complex upload.  `jnp_const` ships real/imag
float32 planes and recombines on device, the same complex-free encoding as
core/runtime.CEnc (kept until its removal is measured on the GPU).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["jnp_const"]


def jnp_const(x) -> jax.Array:
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return jax.lax.complex(
            jnp.asarray(np.ascontiguousarray(x.real).astype(np.float32)),
            jnp.asarray(np.ascontiguousarray(x.imag).astype(np.float32)),
        )
    return jnp.asarray(x)
