import numpy as np

from benchmark import roofline


def test_hand_count():
    # block 1: 0..65535 needs 16 bits; block 2: constant, 0 bits; tail of
    # 10 rows spanning 0..5, 3 bits -> 30 bits -> 4 bytes
    v = np.concatenate([np.arange(65536), np.full(65536, 7), np.array([0, 5] * 5)])
    assert roofline.packed_bytes(v) == 65536 * 16 // 8 + 0 + 4


def test_frame_of_reference_and_strings():
    # a block of 1000..1003 needs 2 bits whatever its offset
    v = np.tile(np.arange(1000, 1004), 65536 // 4)
    assert roofline.packed_bytes(v) == 65536 * 2 // 8
    # three strings in a block: codes 0..2 by first appearance, 2 bits
    s = np.array(["N", "A", "R", "A"] * (65536 // 4))
    assert roofline.packed_bytes(s) == 65536 * 2 // 8
    assert roofline.packed_bytes(np.array(["F", "O"] * 32768)) == 65536 // 8


def test_widths_to_64_bits():
    v = np.array([0, (1 << 62) - 1, 3, 9] * 16384, dtype=np.int64)
    assert roofline.packed_bytes(v) == 65536 * 62 // 8
    assert roofline.least_seconds(3.35e12, 3.35e12) == 1.0
