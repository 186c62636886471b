"""Tests that need an NVIDIA GPU.  They skip elsewhere (the ``gpu`` fixture
decides at run time) and run on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

which ``chip_smoke.py`` does."""

import numpy as np
import pytest

from ofdm_ls_mrc_tpu import FrameConfig
from ofdm_ls_mrc_tpu.golden import dsp

pytestmark = pytest.mark.gpu


def _frame(rng, a, f, s, cp):
    return (0.1 * (rng.standard_normal((s, a, f + cp))
                   + 1j * rng.standard_normal((s, a, f + cp)))
            ).astype(np.complex64)


def test_default_body_is_composed_on_gpu(gpu, rng):
    from ofdm_ls_mrc_tpu.models import UplinkReceiver
    from ofdm_ls_mrc_tpu.models.body import choose_body

    assert gpu.platform == "gpu"
    assert choose_body() == ("composed", "xla")
    cfg = FrameConfig()
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)
                   ).astype(np.complex64)
    assert UplinkReceiver(cfg, pilot).pipeline == "composed"


@pytest.mark.parametrize("pipeline", ["composed", "fast"])
def test_full_width_matches_golden_on_gpu(gpu, rng, pipeline):
    """16 x 1024 x 101 with CP 72 on the card: fp32-grade against the golden
    (the fast body's GEMMs at HIGHEST, so no TF32)."""
    from ofdm_ls_mrc_tpu.models import UplinkReceiver

    cfg = FrameConfig(num_antennas=16, fft_size=1024, cyclic_prefix=72,
                      frame_len=101)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)
                   ).astype(np.complex64)
    frame = _frame(rng, 16, 1024, 101, 72)
    got = UplinkReceiver(cfg, pilot, pipeline=pipeline).demod_frame(
        frame).to_numpy()
    want = dsp.demod_frame(frame, pilot, 72)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    print(f"{pipeline}: rel max err {err:.3e}")
    assert err < 5e-5, err


def test_dft_gemm_is_fp32_on_gpu(gpu, rng):
    """The DFT-as-GEMM FFTs run at HIGHEST precision: a TF32 matmul (about
    1e-3 relative) would fail this fp32 bound."""
    from ofdm_ls_mrc_tpu.ops.cplx import CArray
    from ofdm_ls_mrc_tpu.ops.fft import fft_four_step, fft_matmul

    x = (rng.standard_normal((8, 1024))
         + 1j * rng.standard_normal((8, 1024))).astype(np.complex64)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    for fn in (fft_matmul, fft_four_step):
        got = fn(CArray.from_numpy(x)).to_numpy()
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err < 1e-5, (fn.__name__, err)


def test_summarize_trace_reads_gpu_tracks(gpu, rng, tmp_path):
    """A trace recorded on the card: summarize_trace finds device events on
    the GPU tracks (DEVICE_TRACK) with positive durations."""
    import jax

    from ofdm_ls_mrc_tpu.models import UplinkReceiver
    from ofdm_ls_mrc_tpu.utils import profiling

    cfg = FrameConfig(num_antennas=16, fft_size=1024, cyclic_prefix=0,
                      frame_len=101)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)
                   ).astype(np.complex64)
    rx = UplinkReceiver(cfg, pilot)
    frame = _frame(rng, 16, 1024, 101, 0)
    jax.block_until_ready(rx.demod_frame(frame).re)
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            out = rx.demod_frame(frame)
        jax.block_until_ready(out.re)
    ops = profiling.summarize_trace(str(tmp_path))
    for name, (sec, n) in list(ops.items())[:8]:
        print(f"{sec * 1e6:9.1f} us  x{n:3d}  {name}")
    assert ops, "no events on a GPU device track"
    assert all(sec > 0 and n >= 1 for sec, n in ops.values())
