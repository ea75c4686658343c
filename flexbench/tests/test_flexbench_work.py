"""The bytes each request needs, counted from shapes."""
import pytest

from flexbench import work


def test_a_4096_lba_block_read_needs_its_blocks_checksums_and_lbas():
    # 16 MiB read, 16 MiB written, 16 KiB of checksums, 32 KiB of LBAs
    assert work.block_read_bytes(4096) == 33_603_584
    assert work.block_read_bytes(4096) == (16 << 20) * 2 + (16 << 10) \
        + (32 << 10)
    assert work.block_read_bytes(32) == 32 * 8204


def test_a_roofline_share_needs_device_time():
    assert work.roofline_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert work.roofline_pct(1.0, 0.0) is None
    assert work.roofline_pct(0, 1.0) is None


def test_the_peak_is_the_h100_data_sheets():
    assert work.HBM_BYTES_PER_S == 3.35e12
    assert work.POWER_LIMIT_W == 700.0
