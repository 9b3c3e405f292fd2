"""The roofline counts against the bytes the kernel table in PERF.md
states (FAST B=12 1080p 199 MB, 3000x4000 96 MB; Schur F12/T1024 1.80 MB,
its bound 0.538 us)."""
import _paths  # noqa: F401
import pytest

from harness import roofline


def test_fast_bytes_match_the_kernel_table():
    assert roofline.fast_bytes(12, 1080, 1920) == 199_065_600
    assert round(roofline.fast_bytes(12, 1080, 1920) / 1e6) == 199
    assert roofline.fast_bytes(1, 3000, 4000) == 96_000_000
    assert roofline.bound_s(roofline.fast_bytes(1, 3000, 4000)) * 1e3 == \
        pytest.approx(0.0287, abs=5e-5)


def test_schur_bound_is_its_bytes_at_the_sfm_shape():
    nbytes = roofline.schur_bytes(12, 1024)
    assert nbytes == 1_802_784
    ops = roofline.schur_ops(12, 1024)
    assert ops / roofline.FP32_OPS_PER_S < nbytes / roofline.HBM_BYTES_PER_S
    assert roofline.bound_s(nbytes, ops) * 1e3 == pytest.approx(0.000538,
                                                                abs=1e-6)


def test_hamming_and_remap_bytes():
    # PERF.md rows 4a (2048^2, 256 bits: 17.8 MB) and 6 (12-stack: 215.7 MB)
    assert roofline.hamming_bytes(2048, 2048, 256) / 1e6 == \
        pytest.approx(17.8, abs=0.1)
    assert roofline.remap_bytes(12, 1080, 1920) / 1e6 == \
        pytest.approx(215.7, abs=0.1)
