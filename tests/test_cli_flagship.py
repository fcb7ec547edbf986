"""The channelized FM flow (`-c N --demod "DeNBFM kf WAV"`) through the CLI
entry point against the float64 reference, on cf32 and cu8 capture files,
and the kernel-choice options that are gone."""

import os

import numpy as np
import pytest

from csdr_tpu.apps.soapy_sdr_cli import main as cli_main
from csdr_tpu.io import wav as wavio
from csdr_tpu.models.receivers import channelized_fm_receiver
from csdr_tpu.utils import reference as R

import chip_smoke


@pytest.mark.parametrize("wire", ["cf32", "cu8"])
@pytest.mark.parametrize("nch", [4, 16, 64])
def test_cli_channels_match_float64(tmp_path, nch, wire):
    n = nch * 512
    path, ref_in, k_sig = chip_smoke.write_capture(str(tmp_path), wire, n,
                                                   nch, seed=nch)
    got = chip_smoke.run_cli_channels(path, str(tmp_path / "fm"), n, nch,
                                      block=nch * 128)
    want = R.flagship_reference(ref_in, nch, chip_smoke.KF)
    assert got.shape == (nch, n // nch)
    _, sr = wavio.read_wav(str(tmp_path / "fm_ch1.wav"))
    assert sr == int(chip_smoke.FS) // nch
    chip_smoke.check_channels(f"cli {nch} {wire}", got, want, k_sig)


def test_cli_rejects_backend_flag(tmp_path, capsys):
    os.chdir(tmp_path)
    np.zeros(1024, np.complex64).tofile("z.cf32")
    with pytest.raises(SystemExit) as e:
        cli_main(["--filename", "z.cf32", "-c", "4", "--demod",
                  "DeNBFM 0.6 WAV", "--backend", "pallas_full"])
    assert e.value.code == 2
    assert "--backend" in capsys.readouterr().err


def test_channelized_fm_receiver_has_no_backend():
    with pytest.raises(TypeError):
        channelized_fm_receiver(8, kf=0.6, backend="pallas")
