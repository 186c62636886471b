"""Fast demod path (ops/fastpath) vs golden and composed pipeline."""

import jax
import numpy as np
import pytest

from ofdm_ls_mrc_tpu import FrameConfig
from ofdm_ls_mrc_tpu.golden import dsp
from ofdm_ls_mrc_tpu.models import UplinkReceiver
from ofdm_ls_mrc_tpu.ops.cplx import CArray
from ofdm_ls_mrc_tpu.ops.fastpath import (
    _edge_gather,
    _fast_perm_tables,
    demod_frame_fast,
    fft_permuted,
    prepare_pilot_fast,
)


def crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.mark.parametrize("f", [64, 256, 1024])
def test_fft_permuted_matches_numpy(rng, f):
    x = crandn(rng, (3, f))
    _, inv = _fast_perm_tables(f)
    got = fft_permuted(CArray.from_numpy(x)).to_numpy()[:, inv]
    want = np.fft.fft(x, axis=-1)
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-5)


@pytest.mark.parametrize("f,cp", [(64, 0), (256, 32), (1024, 72)])
def test_demod_fast_matches_golden(rng, f, cp):
    s, a = 7, 4
    frame = crandn(rng, (s, a, f + cp))
    px = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    xp = prepare_pilot_fast(px, f)
    got = jax.jit(lambda fr: demod_frame_fast(fr, xp, cp=cp))(
        CArray.from_numpy(frame)).to_numpy()
    want = dsp.demod_frame(frame, px, cp)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_edge_gather_equals_finalize_semantics(rng):
    """inv-perm + DC-drop + ifftshift folded into one take."""
    f = 256
    perm, inv = _fast_perm_tables(f)
    eq_true = crandn(rng, (f,))
    eq_perm = eq_true[perm]
    want = np.fft.ifftshift(eq_true[1:])
    got = eq_perm[_edge_gather(f)]
    np.testing.assert_array_equal(got, want)


def test_demod_fast_int16_no_wraparound(rng):
    """sc16-native planar int16 frames through the XLA fast path: the
    planes widen (widen_sc16) BEFORE the Karatsuba pre-sum (xre + xim) --
    two near-full-scale int16 samples wrap at +/-32767 otherwise -- so
    int16 output must match the float32 run of the same quantized frame."""
    from ofdm_ls_mrc_tpu.golden.io import SC16_FULL_SCALE
    f, cp, s, a = 256, 0, 5, 4
    frame = crandn(rng, (s, a, f))
    # Near-full-scale: |re|,|im| up to ~0.9, so re+im overflows int16 when
    # summed before widening.
    frame *= 0.9 / np.max(np.abs(frame.view(np.float32)))
    i16 = np.round(frame.view(np.float32) * SC16_FULL_SCALE).astype(np.int16)
    re_i, im_i = i16[..., 0::2], i16[..., 1::2]
    # The exact float equivalent of the quantized int16 planes.
    fre = re_i.astype(np.float32) / SC16_FULL_SCALE
    fim = im_i.astype(np.float32) / SC16_FULL_SCALE
    px = np.exp(2j * np.pi * rng.random(f - 1)).astype(np.complex64)
    xp = prepare_pilot_fast(px, f)
    got_i = demod_frame_fast(CArray(re_i, im_i), xp, cp=cp).to_numpy()
    got_f = demod_frame_fast(CArray(fre, fim), xp, cp=cp).to_numpy()
    np.testing.assert_allclose(got_i, got_f, rtol=1e-4, atol=1e-4)


def test_ls_permuted_is_the_shared_estimate(rng):
    """The one shared LS definition (ops/fastpath.ls_permuted) equals the
    inline math it replaced: h = y_pilot / x (conjugate folded by callers),
    hsq = sum_a |h|^2."""
    from ofdm_ls_mrc_tpu.ops.fastpath import ls_permuted
    a, f = 3, 256
    p = crandn(rng, (a, f))
    xf = crandn(rng, (f,))
    h, hsq = ls_permuted(CArray.from_numpy(p), CArray.from_numpy(xf))
    want_h = p / xf[None]
    np.testing.assert_allclose(np.asarray(h.re) + 1j * np.asarray(h.im),
                               want_h, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(hsq),
                               np.sum(np.abs(want_h) ** 2, axis=0),
                               rtol=1e-4)


def test_receiver_pipelines_agree(rng):
    cfg = FrameConfig(num_antennas=4, fft_size=256, cyclic_prefix=16, frame_len=6)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    frame = crandn(rng, (cfg.frame_len, cfg.num_antennas, cfg.symbol_len))
    fast = UplinkReceiver(cfg, pilot, fft_impl="four_step",
                          pipeline="fast").demod_frame(frame).to_numpy()
    composed = UplinkReceiver(cfg, pilot, fft_impl="four_step",
                              pipeline="composed").demod_frame(frame).to_numpy()
    np.testing.assert_allclose(fast, composed, rtol=1e-4, atol=1e-4)
