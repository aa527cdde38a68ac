"""The port's toolbox on bool images against ``unmicst_tpu.utils.imtools``
(scipy) on the CPU, byte for byte: scipy stores each pass of a Gaussian
filter as C's cast of the double into the bool's byte, so a result can
hold bytes other than 0 and 1, and a later pass reads them back as
numbers; numpy reads any nonzero byte as 1.  The Laplacian's negation
raises ``TypeError`` on bool in both packages."""

import numpy as np
import pytest

from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.utils import imtools as T

CPU = "cpu"
SIGMAS = [0.5, 0.7, 1.0, 1.5, 2.0]
ORDERS = [0, 1, 2]
MODES = [{}, {"mode": "constant", "cval": 1.0}, {"mode": "constant",
                                                  "cval": 3.0},
         {"mode": "constant", "cval": -2.5}]


def _bool_image(shape, seed=5):
    """A block plus 10% random pixels."""
    rng = np.random.RandomState(seed)
    img = np.zeros(shape, bool)
    img[tuple(slice(n // 6, n // 6 + max(2, n * 3 // 8)) for n in shape)] = 1
    return img | (rng.rand(*shape) < 0.1)


def _bytes_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("shape", [(32, 32), (9, 14, 12)])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("sigma", SIGMAS)
def test_gaussian_bytes(shape, order, sigma):
    """Every sigma, derivative order and boundary mode: the stored bytes
    equal scipy's, 2 and 255 among them."""
    img = _bool_image(shape)
    for kwargs in MODES:
        want = J.imgaussfilt(img, sigma, order=order, **kwargs)
        _bytes_equal(T.imgaussfilt(img, sigma, order=order, device=CPU,
                                   **kwargs), want)


def test_gaussian_reads_stored_bytes():
    """A result fed back in: scipy reads its bytes as numbers; per-axis
    orders give bytes beyond 1 on the first pass."""
    img = _bool_image((32, 32))
    once = J.imgaussfilt(img, 0.5, order=[0, 2])
    assert once.view(np.uint8).max() > 1
    _bytes_equal(T.imgaussfilt(img, 0.5, order=[0, 2], device=CPU), once)
    for kwargs in MODES:
        _bytes_equal(T.imgaussfilt(once, 0.7, order=[1, 0], device=CPU,
                                   **kwargs),
                     J.imgaussfilt(once, 0.7, order=[1, 0], **kwargs))


def test_table_cases():
    """The table of the repair: the calls as the JAX toolbox's users
    make them."""
    img = _bool_image((32, 32))
    _bytes_equal(T.imgaussfilt(img, 1.0, device=CPU), J.imgaussfilt(img, 1.0))
    _bytes_equal(T.imgaussfilt(img, 2.0, order=1, device=CPU),
                 J.imgaussfilt(img, 2.0, order=1))
    _bytes_equal(T.imgaussfilt(img, 1.5, mode="constant", cval=1.0,
                               device=CPU),
                 J.imgaussfilt(img, 1.5, mode="constant", cval=1.0))


@pytest.mark.parametrize("shape", [(32, 32), (9, 14, 12)])
@pytest.mark.parametrize("sigma", [0.5, 1.0])
def test_gradmag_and_derivatives(shape, sigma):
    """``imgradmag`` (float16 of numpy's int8 squares) and the derivative
    stacks (float64 planes of 0 and 1) equal the JAX package's."""
    img = _bool_image(shape)
    _bytes_equal(T.imgradmag(img, sigma, device=CPU), J.imgradmag(img, sigma))
    if len(shape) == 2:
        got = T.imderivatives(img, [sigma, 0.7], device=CPU)
        want = J.imderivatives(img, [sigma, 0.7])
        got_f = T.imfeatures(img, sigma_deriv=[sigma], sigma_log=[],
                             loc_stats_rad=2, device=CPU)
        want_f = J.imfeatures(img, sigma_deriv=[sigma], sigma_log=[],
                              loc_stats_rad=2)
    else:
        got = T.imderivatives3(img, [sigma, 0.7], device=CPU)
        want = J.imderivatives3(img, [sigma, 0.7])
        got_f = T.imfeatures3(img, sigma_deriv=[sigma], sigma_log=[],
                              loc_stats_rad=2, device=CPU)
        want_f = J.imfeatures3(img, sigma_deriv=[sigma], sigma_log=[],
                               loc_stats_rad=2)
    _bytes_equal(got, want)
    _bytes_equal(got_f, want_f)
    _bytes_equal(T.localstats(img, 2, device=CPU), J.localstats(img, 2))


@pytest.mark.parametrize("shape", [(32, 32), (9, 14, 12)])
def test_laplacian_refuses_bool(shape):
    """numpy's unary ``-`` refuses bool: ``imlogfilt`` and the feature
    stacks with a LoG plane raise ``TypeError``, as in the JAX package."""
    img = _bool_image(shape)
    feats = (J.imfeatures, T.imfeatures) if len(shape) == 2 else (
        J.imfeatures3, T.imfeatures3)
    calls = [(J.imlogfilt, (img, 1.0), {}), (T.imlogfilt, (img, 1.0),
                                               {"device": CPU}),
             (feats[0], (img,), {"sigma_log": 1}),
             (feats[1], (img,), {"sigma_log": 1, "device": CPU})]
    for fn, args, kwargs in calls:
        with pytest.raises(TypeError, match="boolean negative"):
            fn(*args, **kwargs)


def test_thrsegment_on_bool():
    img = _bool_image((32, 32))
    _bytes_equal(T.thrsegment(img, 0.1, 0.5, device=CPU),
                 J.thrsegment(img, 0.1, 0.5))
