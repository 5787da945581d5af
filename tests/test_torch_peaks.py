"""The port's persistence peak detector (xframe_tpu_torch/library/peaks.py)
against the JAX package's (xframe_tpu/library/peaks.py) on the same seeded
sequences and images: every peak's summit, death, region, persistence and
saddle equal, in the same order, 1D and 2D (periodic or not), and the
dispatch of PeakDetector, refusal included."""
import numpy as np
import pytest

from xframe_tpu.library import peaks as jpk

from xframe_tpu_torch.library import peaks as tpk


def _sequences():
    rng = np.random.default_rng(0)
    x = np.linspace(0, 6 * np.pi, 97)
    return {"hand": np.array([0.0, 3.0, 1.0, 2.0, 0.5]),
            "permutation": rng.permutation(41).astype(float),
            "ties": np.round(rng.random(60) * 5),
            "waves": np.sin(x) + 0.3 * np.sin(5.3 * x) + 0.05 * x,
            "flat": np.zeros(7)}


def _images():
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:32, 0:48].astype(float)
    bumps = np.exp(-((yy - 10) ** 2 + (xx - 12) ** 2) / 18.0) \
        + 0.6 * np.exp(-((yy - 22) ** 2 + (xx - 36) ** 2) / 18.0)
    return {"bumps": bumps,
            "permutation": rng.permutation(600).reshape(30, 20).astype(float),
            "noisy": bumps + 0.05 * rng.random(bumps.shape),
            "ties": np.round(rng.random((12, 9)) * 3)}


@pytest.mark.parametrize("name", sorted(_sequences()))
def test_peaks_1d_match_jax(name):
    seq = _sequences()[name]
    got, want = tpk.find_peaks_1d(seq), jpk.find_peaks_1d(seq)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.born, a.died, a.left, a.right) \
            == (b.born, b.died, b.left, b.right)
        assert a.persistence(seq) == b.persistence(seq)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name", sorted(_images()))
def test_peaks_2d_match_jax(name, periodic):
    im = _images()[name]
    got = tpk.find_peaks_2d(im, periodic=periodic)
    want = jpk.find_peaks_2d(im, periodic=periodic)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.born, a.saddle, a.birth_value, a.persistence) \
            == (b.born, b.saddle, b.birth_value, b.persistence)


def test_detector_dispatch_matches_jax():
    for dim, data in ((1, [0.0, 1.0, 0.0]), (2, np.eye(4))):
        got = tpk.PeakDetector.find_peaks(dim, data)
        want = jpk.PeakDetector.find_peaks(dim, data)
        assert [vars(p) for p in got] == [vars(p) for p in want]
    with pytest.raises(ValueError, match="dim 1 or 2"):
        tpk.PeakDetector.find_peaks(3, np.zeros((2, 2, 2)))
