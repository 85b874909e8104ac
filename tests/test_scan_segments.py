"""Edge semantics of the vectorized restart-segment scan.

The scan (host/parser.py:_scan_entropy_segments) classifies every 0xFF
with array ops; these tests pin the byte-level corner behaviors the old
loop form defined: stuffed bytes, fill bytes before markers, RSTn
sequence validation, truncated streams with no terminating marker.
"""

import numpy as np
import pytest

from jaxjpeg.errors import JpegFormatError
from jaxjpeg.host.parser import _scan_entropy_segments


def _scan(data, expected=None, validate=True):
    segs, end = _scan_entropy_segments(data, 0, expected, validate)
    return [tuple(map(int, row)) for row in segs], end


def test_plain_single_segment_terminated():
    data = b"\x12\x34\x56" + b"\xff\xd9"
    segs, end = _scan(data)
    assert segs == [(0, 3)] and end == 3


def test_stuffed_bytes_stay_inside_segment():
    data = b"\xff\x00\xab\xff\x00" + b"\xff\xd9"
    segs, end = _scan(data)
    assert segs == [(0, 5)] and end == 5


def test_rst_sequence_and_spans():
    data = b"\xaa" + b"\xff\xd0" + b"\xbb\xbb" + b"\xff\xd1" + b"\xcc" + b"\xff\xd9"
    segs, end = _scan(data)
    assert segs == [(0, 1), (3, 5), (7, 8)] and end == 8


def test_rst_out_of_sequence_raises_with_validate():
    data = b"\xaa" + b"\xff\xd1" + b"\xbb" + b"\xff\xd9"  # expects RST0 first
    with pytest.raises(JpegFormatError, match="out of sequence"):
        _scan(data)
    segs, _ = _scan(data, validate=False)
    assert segs == [(0, 1), (3, 4)]


def test_fill_bytes_before_marker():
    # FF FF D0: the first FF is a fill byte; the RST is found at the
    # second FF, so the segment span includes the fill byte (the loop
    # form's behavior, preserved).
    data = b"\xaa" + b"\xff\xff\xd0" + b"\xbb" + b"\xff\xd9"
    segs, end = _scan(data)
    assert segs == [(0, 2), (4, 5)] and end == 5


def test_truncated_stream_no_terminator():
    data = b"\x01\x02\x03"
    segs, end = _scan(data)
    assert segs == [(0, 3)] and end == 3


def test_truncated_after_rst():
    data = b"\xaa" + b"\xff\xd0" + b"\xbb"
    segs, end = _scan(data)
    assert segs == [(0, 1), (3, 4)] and end == 4


def test_trailing_ff_at_eof_is_data():
    # Lone 0xFF at EOF: next byte reads as 0 -> treated as stuffed.
    data = b"\xaa\xff"
    segs, end = _scan(data)
    assert segs == [(0, 2)] and end == 2


def test_expected_segment_count_enforced():
    data = b"\xaa" + b"\xff\xd0" + b"\xbb" + b"\xff\xd9"
    with pytest.raises(JpegFormatError, match="expected 3"):
        _scan(data, expected=3)
    segs, _ = _scan(data, expected=2)
    assert len(segs) == 2


def test_rst_after_terminator_ignored():
    data = b"\xaa" + b"\xff\xd9" + b"\xff\xd0\xbb"
    segs, end = _scan(data)
    assert segs == [(0, 1)] and end == 1


def test_returns_int64_array():
    segs, _ = _scan_entropy_segments(b"\xaa\xff\xd9", 0, None, True)
    assert isinstance(segs, np.ndarray)
    assert segs.dtype == np.int64 and segs.shape == (1, 2)
