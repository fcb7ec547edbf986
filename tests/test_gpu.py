"""Tests that need an NVIDIA GPU.  They skip elsewhere; `python
chip_smoke.py` runs them on the card (in its own process)."""

import numpy as np
import pytest

import csdr_tpu as cs
from csdr_tpu.core.runtime import Pipeline
from csdr_tpu.models.receivers import channelized_fm_receiver
from csdr_tpu.utils import reference as R
from csdr_tpu.utils import testsig

from chip_smoke import SNR_FLOOR_DB

pytestmark = pytest.mark.gpu


def test_runs_on_the_gpu(gpu):
    import jax

    assert jax.default_backend() == "gpu"
    assert gpu.platform == "gpu"


def test_f32_matmul_is_full_precision_on_gpu(gpu):
    """csdr_tpu sets jax_default_matmul_precision="highest": a float32
    product must carry float32 accuracy, not TF32's ~1e-3."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.normal(size=(512, 512)).astype(np.float32)
    b = rng.normal(size=(512, 512)).astype(np.float32)
    got = np.asarray(jax.jit(jnp.matmul)(a, b))
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5


@pytest.mark.parametrize("wire", ["cf32", "cu8"])
def test_flagship_matches_float64_on_gpu(gpu, wire):
    """The XLA flagship graph on the card, 64 channels, 4 carried blocks of
    2^19 samples, against the float64 reference."""
    nch, block, n_blocks = 64, 1 << 19, 4
    iq, k_sig = testsig.fm_channel_capture(block * n_blocks, nch, seed=11)
    graph = channelized_fm_receiver(nch, kf=0.6)
    if wire == "cu8":
        src = testsig.to_cu8(iq)
        ref_in = R.cu8_to_iq(src)
        pipe = Pipeline(cs.chain(cs.u8_to_iq(), graph), block_size=2 * block)
    else:
        src, ref_in = iq, iq
        pipe = Pipeline(graph, block_size=block)
    sink = cs.CollectSink()
    pipe.run(iter([src]), sink)
    got = np.asarray(sink.concat())
    want = R.flagship_reference(ref_in, nch)
    assert got.shape == want.shape
    assert np.min(R.channel_snr_db(want, got)[k_sig]) > SNR_FLOOR_DB
