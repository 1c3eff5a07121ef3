"""What only a card can check: the device trace's alignment by its marker
kernel and its reduction. Run on a machine with a card:
python -m pytest benchmark/tests -q -m card"""

import time

import pytest

from benchmark import trace


@pytest.mark.card
def test_device_trace_finds_the_marker(card):
    import torch

    spans = trace.Spans(1)
    dt = trace.DeviceTrace(card)
    dt.start()
    t0 = dt.mark()
    x = torch.ones(1 << 24, device=card)
    for _ in range(20):
        x = x * 1.0001
    torch.cuda.synchronize(card)
    t1 = time.perf_counter()
    spans.add(0, "work", t0, t1)
    events = dt.stop()
    spans.freeze()
    s = trace.reduce_events(events, t0, t1, spans)
    assert dt.aligned_by_marker
    assert s["kernels"] >= 20 and 0 < s["busy_s"] <= s["window_s"]
