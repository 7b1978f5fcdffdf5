"""The port's median of 31 (HPSS) against the JAX package's.

``median31_reference`` (the plain PyTorch version, and what ``median31``
runs for a CPU tensor) must equal JAX's ``median_filter_1d`` and the
Pallas kernels (interpret mode) bit for bit: a median only selects
values. The CUDA kernel is held to its plain version on the card; that
test skips on a host without CUDA.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from track_analyser_tpu.ops.filters import median_filter_1d as jax_median_filter_1d
from track_analyser_tpu_torch.ops.median import median31, median31_reference

torch.set_num_threads(2)

# Not multiples of the Pallas (32, 512) tile; (7, 20) and (40, 9) are
# shorter than the window, so the reflection bounces more than once.
_SHAPES = [(40, 700), (33, 513), (1025, 65), (7, 20), (40, 9)]


def _x(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("axis", [-1, -2])
def test_reference_matches_jax_median_filter(shape, axis) -> None:
    x = _x(shape)
    ref = np.asarray(jax_median_filter_1d(jnp.asarray(x), 31, axis=axis))
    got = median31_reference(torch.from_numpy(x), axis).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("axis", [-1, -2])
def test_batched_reference_matches_per_lane(axis) -> None:
    x = _x((3, 33, 100), seed=1)
    got = median31_reference(torch.from_numpy(x), axis).numpy()
    for lane in range(x.shape[0]):
        ref = np.asarray(jax_median_filter_1d(jnp.asarray(x[lane]), 31, axis=axis))
        np.testing.assert_array_equal(got[lane], ref)


def test_reference_matches_pallas_kernels_in_interpret_mode() -> None:
    from track_analyser_tpu.ops.pallas_median import median31_first_axis, median31_last_axis

    x = _x((33, 513), seed=2)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        median31_reference(t, -1).numpy(),
        np.asarray(median31_last_axis(jnp.asarray(x), interpret=True)),
    )
    np.testing.assert_array_equal(
        median31_reference(t, -2).numpy(),
        np.asarray(median31_first_axis(jnp.asarray(x), interpret=True)),
    )


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_nothing() -> None:
    x = torch.from_numpy(_x((40, 700), seed=3))
    before = median31.launches
    for axis in (-1, -2, 1, 0):
        expected = median31_reference(x, -1 if axis in (-1, 1) else -2)
        assert torch.equal(median31(x, axis), expected)
    assert median31.launches == before


@pytest.mark.parametrize(
    "bad,error",
    [
        (torch.zeros(40, 70, dtype=torch.float64), TypeError),
        (torch.zeros(70), ValueError),
        (torch.zeros(2, 2, 40, 70), ValueError),
        (torch.zeros(70, 40).T, ValueError),  # not contiguous
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, error) -> None:
    with pytest.raises(error):
        median31(bad, -1)


def test_wrapper_rejects_other_axes() -> None:
    with pytest.raises(ValueError):
        median31(torch.zeros(2, 40, 70), 0)


@pytest.mark.gpu
def test_cuda_kernel_is_bit_identical_to_plain_version() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the median31 kernel has no CPU mode")
    for shape in [(1025, 16_385), (33, 513), (1025, 65), (2, 1025, 4097), (7, 20)]:
        x = torch.rand(shape, device="cuda")
        for axis in (-1, -2):
            before = median31.launches
            got = median31(x, axis)
            torch.cuda.synchronize()
            assert median31.launches == before + 1
            assert torch.equal(got, median31_reference(x, axis)), (shape, axis)
