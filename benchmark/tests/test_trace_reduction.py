from benchmark import trace


def test_union_busy_gaps_and_labels():
    spans = trace.Spans(2)
    spans.add(0, "query q1", 0.0, 0.5)
    spans.add(0, "execute q1", 0.1, 0.5)
    spans.add(1, "fetch q6", 0.55, 0.9)
    spans.freeze()
    events = [("kernA", 0.10, 0.20), ("kernA", 0.15, 0.30), ("Memcpy HtoD", 0.60, 0.70),
              ("kernB", 0.95, 1.20), ("kernC", -1.0, -0.5)]
    s = trace.reduce_events(events, 0.0, 1.0, spans)
    assert abs(s["busy_s"] - (0.2 + 0.1 + 0.05)) < 1e-12
    assert s["kernels"] == 3 and s["window_s"] == 1.0
    assert s["device_ops"][0][0] == "kernA"
    (label, length), *_ = s["idle_gaps"]
    # the longest gap is 0.30-0.60: client 0 executes q1 until 0.5, client 1 fetches from 0.55
    assert abs(length - 0.3) < 1e-12 and label == "between queries+execute q1"
    assert trace.union([(0, 1), (0.5, 2), (3, 4)]) == [(0, 2), (3, 4)]
