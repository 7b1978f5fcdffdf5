"""The yardstick's byte count of HPSS's medians."""

import pytest

from h100_bench import roofline


def test_median31_bound_at_the_kernel_table_shape():
    # one (1025, 16 385) float32 read and one written over 3.35 TB/s
    assert roofline.median31_bytes(16_385) == 2 * 1025 * 16_385 * 4
    assert roofline.median31_bound_s(16_385) * 1e3 == pytest.approx(0.0401, abs=5e-5)


def test_frames_are_the_tracks_own():
    # a 181 s track: its centred frames, not the 8 388 608-sample bucket's 16 385
    assert roofline.hpss_frames(roofline.analysis_samples(181 * 44_100, 44_100)) == 1 + 181 * 44_100 // 512 == 15_591


def test_clips_resample_to_the_analysis_rate():
    assert roofline.analysis_samples(30 * 22_050, 22_050) == 30 * 44_100
    assert roofline.hpss_frames(30 * 44_100) == 2_584
