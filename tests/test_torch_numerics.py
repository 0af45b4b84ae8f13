"""``repro_torch.util.numerics.sqrt_rn`` against ``numpy.sqrt`` (IEEE
correctly rounded), bitwise, on 2^20 float32 draws at three scales; and the
fault it repairs, ``torch.sqrt`` on the CPU, counted where this host has it.
Tolerance: none, every bit."""
import numpy as np
import pytest
import torch

from repro_torch.util.numerics import sqrt_rn

N = 1 << 20


def _draws(scale: float) -> np.ndarray:
    return (np.random.default_rng(0).random(N, dtype=np.float32) * np.float32(scale)).astype(
        np.float32)


@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e3])
def test_sqrt_rn_is_numpys_bitwise(scale):
    x = _draws(scale)
    got = sqrt_rn(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.sqrt(x).view(np.int32))


def test_sqrt_rn_keeps_other_dtypes_and_shapes():
    x = torch.rand(3, 4, dtype=torch.float64)
    assert torch.equal(sqrt_rn(x), torch.sqrt(x))
    assert sqrt_rn(torch.tensor(4.0)).shape == () and float(sqrt_rn(torch.tensor(4.0))) == 2.0


def test_torch_sqrt_misses_are_what_sqrt_rn_repairs():
    """Every element where this host's ``torch.sqrt`` misses numpy's root is
    one ulp off, and ``sqrt_rn`` has it right (the count is the host's:
    0 on some, ~1.8e5 of 2^20 at scale 1e-6 on an AVX512 host)."""
    x = _draws(1e-6)
    want = np.sqrt(x).view(np.int32)
    plain = torch.sqrt(torch.from_numpy(x)).numpy().view(np.int32)
    miss = plain != want
    assert np.all(np.abs(plain[miss].astype(np.int64) - want[miss]) == 1)
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(x[miss])).numpy().view(np.int32),
                                  want[miss])
