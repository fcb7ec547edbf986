"""The XLA flagship graph against the float64 reference
(csdr_tpu.utils.reference), on cf32 and cu8 input, in one block and in
three blocks with the state carried between them."""

import numpy as np
import pytest

import csdr_tpu as cs
from csdr_tpu.core.runtime import Pipeline
from csdr_tpu.models.receivers import channelized_fm_receiver
from csdr_tpu.ops.pfb import pfb_taps
from csdr_tpu.utils import reference as R
from csdr_tpu.utils import testsig

from chip_smoke import SNR_FLOOR_DB

FRAMES = 256  # frames per block


def run_flagship(nch, wire, n_blocks, seed=5):
    """→ (device output (nch, n/nch), float64 reference, signal channels)."""
    n = nch * FRAMES * n_blocks
    iq, k_sig = testsig.fm_channel_capture(n, nch, seed=seed)
    graph = channelized_fm_receiver(nch, kf=0.6)
    if wire == "cu8":
        src = testsig.to_cu8(iq)
        ref_in = R.cu8_to_iq(src)
        graph = cs.chain(cs.u8_to_iq(), graph)
        block = 2 * nch * FRAMES
    else:
        src, ref_in, block = iq, iq, nch * FRAMES
    pipe = Pipeline(graph, block_size=block, donate=False)
    sink = cs.CollectSink()
    pipe.run(iter([src]), sink)
    return np.asarray(sink.concat()), R.flagship_reference(ref_in, nch), k_sig


@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("wire", ["cf32", "cu8"])
@pytest.mark.parametrize("nch", [2, 4, 8, 16, 32, 64])
def test_xla_flagship_matches_float64(nch, wire, n_blocks):
    got, want, k_sig = run_flagship(nch, wire, n_blocks)
    assert got.shape == want.shape == (nch, FRAMES * n_blocks)
    assert np.all(np.isfinite(got))
    snr = R.channel_snr_db(want, got)
    assert np.min(snr[k_sig]) > SNR_FLOOR_DB, snr[k_sig]


@pytest.mark.parametrize("nch", [4, 64])
def test_reference_prototype_matches_filter_design(nch):
    """The reference derives liquid's PFB prototype on its own; it must be
    the design the device graph uses (csdr_tpu.ops.pfb)."""
    h = R.pfb_prototype(nch)
    assert np.max(np.abs(h - pfb_taps(nch).reshape(-1))) < 1e-7


def test_reference_cu8_conversion_matches_device():
    u8 = np.arange(512, dtype=np.uint16).astype(np.uint8)
    pipe = Pipeline(cs.u8_to_iq(), block_size=512, donate=False)
    sink = cs.CollectSink()
    pipe.run(iter([u8]), sink)
    got = np.asarray(sink.concat())
    assert np.max(np.abs(got - R.cu8_to_iq(u8))) < 1e-6  # float32 rounding
