"""The port's ``--scalingFactor`` resize against the JAX package on the CPU.

``unmicst_tpu_torch.core.resize_dev.ResizePlan`` (float32 torch ops)
against ``unmicst_tpu.core.resize_dev.ResizePlan`` (jitted), and the host
float64 resize of ``unmicst_tpu_torch.io.preprocess`` (``resize``,
``resize_rows``, ``ResampledSource``, ``upscale_pm``, ``postprocess_pm``)
against ``unmicst_tpu.io.preprocess`` on the same seeded numpy inputs.
Bars: 2e-6 on the device plan (``tests/test_infer_slide_scale.py``), 1e-12
on the host resize and the streamed statistics.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import ndimage

from unmicst_tpu.core.resize_dev import ResizePlan as JaxPlan
from unmicst_tpu.io import preprocess as jpp
from unmicst_tpu.io.tiff import TiffFile, TiffWriter
from unmicst_tpu_torch.core.resize_dev import ResizePlan
from unmicst_tpu_torch.io import preprocess as pp

# tests/test_infer_slide_scale.py:55-59: down, up, mixed, a 1-wide axis,
# and extreme downscales whose gaussian reaches past the axis
_PLAN_SHAPES = [((60, 80), (30, 40)), ((60, 80), (120, 160)),
                ((45, 31), (29, 62)), ((7, 1), (3, 5)),
                ((8, 300), (1, 30)), ((6, 6), (2, 2))]


def _u16(shape, seed):
    return (np.random.RandomState(seed).rand(*shape) * 65535).astype(
        np.uint16)


@pytest.mark.parametrize("shape,out", _PLAN_SHAPES)
def test_resize_plan_matches_jax(shape, out):
    x = _u16(shape, shape[0] * 7 + out[1])
    unit = x.astype(np.float32) / 65535.0
    want = np.asarray(jax.jit(JaxPlan(shape, out).apply)(unit))
    plan = ResizePlan(shape, out, "cpu")
    got = plan.apply(torch.from_numpy(unit))
    assert got.dtype == torch.float32 and tuple(got.shape) == out
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    # a channel axis in front resizes each channel alike
    both = plan.apply(torch.from_numpy(np.stack([unit, unit[::-1].copy()])))
    np.testing.assert_array_equal(both[0].numpy(), got.numpy())
    np.testing.assert_allclose(
        both[1].numpy(),
        np.asarray(jax.jit(JaxPlan(shape, out).apply)(unit[::-1].copy())),
        atol=2e-6, rtol=0)


def test_resize_plan_identity_and_degenerate():
    x = torch.rand(2, 9, 7)
    assert ResizePlan((9, 7), (9, 7)).apply(x) is x
    with pytest.raises(ValueError, match="degenerate"):
        ResizePlan((9, 7), (0, 3))


@pytest.mark.parametrize("sigmas,shape", [
    ((0.5, 0.25), (40, 33)), ((3.0, 0.0), (9, 50)), ((0.0, 7.5), (5, 4)),
    ((12.0, 1.3), (3, 30)), ((0.8, 0.8), (1, 17)),
])
def test_gaussian_filter_is_scipys_bit_for_bit(sigmas, shape):
    """The float64 tap-sum in scipy's order, scipy's mirror boundary at any
    reach (radius past the axis included)."""
    x = np.random.RandomState(len(shape) + shape[0]).rand(*shape)
    np.testing.assert_array_equal(
        pp.gaussian_filter(x, sigmas),
        ndimage.gaussian_filter(x, sigmas, mode="mirror"))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8, np.float32])
@pytest.mark.parametrize("shape,out", [((150, 90), (75, 45)),
                                       ((101, 67), (50, 33)),
                                       ((60, 40), (90, 60)),
                                       ((128, 96), (47, 35))])
def test_host_resize_matches_jax(shape, out, dtype):
    x = _u16(shape, shape[1])
    x = (x // 257).astype(np.uint8) if dtype == np.uint8 else x.astype(dtype)
    if dtype == np.float32:
        x = x / np.float32(65535.0)
    np.testing.assert_allclose(pp.resize(x, out), jpp.resize(x, out),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("shape,out", [((150, 90), (75, 45)),
                                       ((101, 67), (50, 33)),
                                       ((60, 40), (90, 60)),
                                       ((128, 96), (47, 35))])
def test_resize_rows_blockwise_equals_whole(shape, out):
    """tests/test_pipeline.py:176: row blocks of any size reassemble the
    whole resize bit for bit."""
    img = _u16(shape, out[0])
    whole = pp.resize(img, out)
    np.testing.assert_allclose(whole, jpp.resize(img, out), atol=1e-12,
                               rtol=0)
    for block in (1, 7, 32):
        parts = [pp.resize_rows(lambda a, b: img[a:b], shape, out, r0,
                                min(block, out[0] - r0))
                 for r0 in range(0, out[0], block)]
        np.testing.assert_array_equal(np.concatenate(parts), whole)


@pytest.mark.parametrize("raw_shape", [(150, 90), (97, 61), (40, 160)])
def test_upscale_and_postprocess_match_jax(raw_shape):
    rng = np.random.RandomState(raw_shape[0])
    small = (raw_shape[0] // 2, raw_shape[1] // 2)
    pm_u8 = (rng.rand(*small) * 256).astype(np.uint8)
    got = pp.upscale_pm(pm_u8, raw_shape, block=16)
    np.testing.assert_array_equal(got, jpp.upscale_pm(pm_u8, raw_shape))
    assert got.dtype == np.uint8 and got.shape == raw_shape
    pm = rng.rand(*small)
    np.testing.assert_array_equal(pp.postprocess_pm(pm, raw_shape),
                                  jpp.postprocess_pm(pm, raw_shape))
    # the blocked upscale is the whole postprocess of the same uint8 map
    np.testing.assert_array_equal(
        pp.upscale_pm(np.uint8(255 * pm), raw_shape),
        pp.postprocess_pm(pm, raw_shape))
    same = rng.rand(*raw_shape)  # scale 1: the lookup-table path
    np.testing.assert_array_equal(pp.postprocess_pm(same, raw_shape),
                                  jpp.postprocess_pm(same, raw_shape))


@pytest.mark.parametrize("outlier", [-1, 99.2, 50.0, 0.0])
@pytest.mark.parametrize("cap", [1 << 22, 64])
def test_resampled_source_stats_match_jax(monkeypatch, outlier, cap):
    """Exact percentile over the virtual resized image (a small value cap
    drives the histogram refinement), within 1e-12 of JAX's and of
    np.percentile over the whole resize."""
    img = _u16((140, 80), 3)
    monkeypatch.setattr(pp, "_PERCENTILE_CAP", cap)
    monkeypatch.setattr(jpp, "_PERCENTILE_CAP", cap)
    got = pp.ResampledSource(img, 0.5).stats(outlier)
    want = jpp.ResampledSource(img, 0.5).stats(outlier)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    resized = pp.resize(img, (70, 40))
    assert got[0] == resized.min()
    hi = resized.max() if outlier == -1 else np.percentile(resized, outlier)
    assert abs(got[1] - hi) < 1e-12


def test_resampled_source_reads_like_jax(tmp_path):
    """Rows of an array, a (TiffFile, page) pair (float32 parity cast) and
    a windowed source; zero outside; the raw-unit pin conversion."""
    from unmicst_tpu_torch.io import slides
    from unmicst_tpu_torch.io import tiff as port_tiff

    img = _u16((120, 70), 4)
    src, jsrc = pp.ResampledSource(img, 0.37), jpp.ResampledSource(img, 0.37)
    assert (src.height, src.width, src.dtype) == (jsrc.height, jsrc.width,
                                                  jsrc.dtype)
    np.testing.assert_array_equal(src.read_rows(-3, 50),
                                  jsrc.read_rows(-3, 50))
    assert src.read_rows(-3, 50)[:3].max() == 0
    fn = str(tmp_path / "f.tif")
    with TiffWriter(fn, bigtiff=False) as tw:
        tw.write(img.astype(np.float32) + 0.5)
    with port_tiff.TiffFile(fn) as tf, TiffFile(fn) as jtf:
        np.testing.assert_array_equal(
            pp.ResampledSource((tf, 0), 0.5).read_rows(0, 60),
            jpp.ResampledSource((jtf, 0), 0.5).read_rows(0, 60))
    with slides.open_channel_source(fn, "tif", 0) as cs:
        np.testing.assert_array_equal(
            pp.ResampledSource(cs, 0.5).read_rows(10, 20),
            jpp.ResampledSource(img, 0.5).read_rows(10, 20))
    assert pp.pinned_to_source_units((655.35, 6553.5), src) == \
        jpp.pinned_to_source_units((655.35, 6553.5), jsrc)
    assert pp.pinned_to_source_units([(0, 65535), (10, 20)], src) == \
        jpp.pinned_to_source_units([(0, 65535), (10, 20)], jsrc)
    with pytest.raises(ValueError, match="shrinks"):
        pp.ResampledSource(img[:5, :5], 0.1)
    with pytest.raises(NotImplementedError):
        pp.img_as_float(np.zeros(3, np.int64))
