"""Morse decoder (models/morse.py): keyed carrier → text."""

import numpy as np
import pytest

import csdr_tpu as cs
from csdr_tpu.models import morse

FS = 8000.0


def keyed_carrier(text: str, wpm: float = 20.0, fs: float = FS,
                  freq_off: float = 0.0, seed: int = 0) -> np.ndarray:
    """ITU element timing: dit = 1.2/wpm seconds."""
    unit = int(round(1.2 / wpm * fs))
    key = []
    for word in text.split(" "):
        for ch in word:
            for el in morse._CODE[ch]:
                key += [1] * (unit if el == "." else 3 * unit) + [0] * unit
            key = key[:-unit] + [0] * (3 * unit)  # char gap
        key = key[:-3 * unit] + [0] * (7 * unit)  # word gap
    key = np.array([0] * (2 * unit) + key + [0] * (2 * unit), np.float32)
    n = len(key)
    t = np.arange(n)
    carrier = np.exp(2j * np.pi * freq_off / fs * t)
    rng = np.random.default_rng(seed)
    noise = 0.03 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return (key * carrier + noise).astype(np.complex64)


@pytest.mark.parametrize("wpm", [15.0, 25.0])
def test_morse_decode_through_envelope_chain(wpm):
    text = "CQ CQ DE N0CALL K"
    iq = keyed_carrier(text, wpm=wpm)
    snk = cs.CollectSink()
    cs.Pipeline(morse.cw_envelope(100.0 / FS), block_size=1 << 14).run(
        iter([iq]), snk)
    assert morse.decode_envelope(snk.concat()) == text


def test_morse_decode_with_frequency_offset():
    """A mistuned carrier inside the filter bandwidth still decodes (the
    envelope is magnitude — phase/frequency drop out)."""
    iq = keyed_carrier("JAX SDR 73", wpm=20.0, freq_off=30.0)
    snk = cs.CollectSink()
    cs.Pipeline(morse.cw_envelope(100.0 / FS), block_size=1 << 14).run(
        iter([iq]), snk)
    assert morse.decode_envelope(snk.concat()) == "JAX SDR 73"


def test_morse_edge_cases():
    assert morse.decode_envelope(np.zeros(1000)) == ""
    with pytest.raises(ValueError, match="bandwidth"):
        morse.cw_envelope(0.9)
