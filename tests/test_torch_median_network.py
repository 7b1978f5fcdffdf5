"""The median31 kernel's generated network against the JAX package's medians.

``ops/median.tile_network(r)`` is the schedule that ``csrc/median31.cu``
runs for a run of ``r`` outputs a thread, and ``median31_network`` runs
the same schedule with ``torch.minimum`` / ``torch.maximum`` over
reflect-padded runs. A network only selects values, so at every shape and
input it must equal bit for bit ``median31_reference``, JAX's
``median_filter_1d`` and the Pallas kernels in interpret mode; that holds
on ties too (8 levels with exact zeros, all equal). The block committed in
the CUDA source must be what the generator writes now, and ``chip_smoke.py``
must bound the kernel by the count the generator reports.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from track_analyser_tpu.ops.filters import median_filter_1d as jax_median_filter_1d
from track_analyser_tpu_torch.ops import cuda_build, median

torch.set_num_threads(2)

# Not multiples of the Pallas (32, 512) tile; (7, 20) and (40, 9) are
# shorter than the window, so the reflection bounces more than once.
SHAPES = [(40, 700), (33, 513), (1025, 65), (7, 20), (40, 9), (3, 33, 100)]
KINDS = ["normal", "ties", "equal"]
# The kernel's run lengths, the others profile_median builds, and one
# output a thread.
RUNS = sorted({1, 8, 16, 32, median.RUN_TIME, median.RUN_FREQ})


def make_input(shape, kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32)
    if kind == "ties":  # 8 levels, exact (positive) zeros among them
        return rng.integers(0, 8, size=shape).astype(np.float32) * np.float32(0.25)
    return np.full(shape, 0.75, dtype=np.float32)


@lru_cache(maxsize=None)
def jax_references(shape, kind: str, axis: int) -> tuple[np.ndarray, np.ndarray]:
    """(JAX median_filter_1d, the Pallas kernel in interpret mode) along
    ``axis``; the Pallas kernels take one (F, T) lane at a time."""

    from track_analyser_tpu.ops.pallas_median import median31_first_axis, median31_last_axis

    x = make_input(shape, kind)
    filtered = np.asarray(jax_median_filter_1d(jnp.asarray(x), 31, axis=axis))
    pallas = median31_last_axis if axis == -1 else median31_first_axis
    lanes = x if x.ndim == 3 else x[None]
    kernel = np.stack([np.asarray(pallas(jnp.asarray(lane), interpret=True)) for lane in lanes])
    return filtered, kernel.reshape(x.shape)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("shape", SHAPES)
def test_generated_network_equals_reference_jax_and_pallas(shape, axis, kind) -> None:
    x = torch.from_numpy(make_input(shape, kind))
    reference = median.median31_reference(x, axis).numpy()
    filtered, pallas = jax_references(shape, kind, axis)
    np.testing.assert_array_equal(reference, filtered)
    np.testing.assert_array_equal(reference, pallas)
    for r in RUNS:
        got = median.median31_network(x, axis, r).numpy()
        np.testing.assert_array_equal(got, reference, err_msg=f"runs of {r}")


@pytest.mark.parametrize("r", range(1, 33))
def test_every_run_length_is_exact(r) -> None:
    rng = np.random.default_rng(r)
    x = np.where(rng.random((5, 97)) < 0.5, rng.normal(size=(5, 97)), rng.integers(0, 4, (5, 97)))
    t = torch.from_numpy(x.astype(np.float32))
    for axis in (-1, -2):
        assert torch.equal(median.median31_network(t, axis, r), median.median31_reference(t, axis))


def test_network_is_pruned_and_ordered() -> None:
    for r in RUNS:
        net = median.tile_network(r)
        n = r + 30
        for i, (_is_max, a, b) in enumerate(net.ops):
            assert a < n + i and b < n + i, (r, i)  # reads only earlier values
        read = {v for _is_max, a, b in net.ops for v in (a, b)} | set(net.outputs)
        assert set(range(n, n + net.count)) <= read, r  # every op's result is read
        assert len(net.outputs) == r
    assert median.tile_network(1).count == 274  # a pruned odd-even mergesort of 31
    assert median.tile_network(median.RUN_TIME).per_output < 351
    assert median.tile_network(median.RUN_FREQ).per_output < 351
    for bad in (0, 33):
        with pytest.raises(ValueError):
            median.tile_network(bad)


def test_committed_block_is_what_the_generator_writes() -> None:
    text = (cuda_build.CSRC / "median31.cu").read_text()
    assert median.source_block(text) == median.cuda_block()
    for r in {median.RUN_TIME, median.RUN_FREQ}:
        assert f"static constexpr int kMinMax = {median.tile_network(r).count};" in text


def test_chip_smoke_bounds_the_kernel_by_the_generated_count() -> None:
    assert chip_smoke.median_network(-1) == (median.RUN_TIME, median.tile_network(median.RUN_TIME).per_output)
    assert chip_smoke.median_network(-2) == (median.RUN_FREQ, median.tile_network(median.RUN_FREQ).per_output)


@pytest.mark.gpu
def test_cuda_kernel_on_ties_and_short_axes() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the median31 kernel has no CPU mode")
    for shape in SHAPES + [(1, 5), (2, 1025, 4097)]:
        for kind in KINDS:
            x = torch.from_numpy(make_input(shape, kind)).cuda()
            for axis in (-1, -2):
                got = median.median31(x, axis)
                torch.cuda.synchronize()
                assert torch.equal(got, median.median31_reference(x, axis)), (shape, kind, axis)
