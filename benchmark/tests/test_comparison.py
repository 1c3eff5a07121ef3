from fractions import Fraction

import numpy as np

from benchmark import compare


def test_exact_and_gaps():
    want = [("A", "F", Fraction(1, 3), 10)]
    wrong, gap = compare.answer_gap([("A", "F", np.float64(1 / 3), np.int64(10))], want)
    assert not wrong and gap < 1e-16
    wrong, gap = compare.answer_gap([("A", "F", 0.3334, 10)], want)
    assert not wrong and abs(gap - 0.0002) < 1e-6
    assert compare.answer_gap([("A", "O", 1 / 3, 10)], want)[0]
    assert compare.answer_gap([], want)[0]
    assert compare.answer_gap([("A", "F", None, 10)], want)[1] == float("inf")
    assert compare.answer_gap([("A", "F", float("nan"), 10)], want)[1] == float("inf")
    assert compare.answer_gap([(np.uint32(7),)], [(7,)]) == (False, 0.0)


def test_judge():
    t = compare.Tally()
    t.add("a", [(1.0,)], [(1,)])
    ok, checks = compare.judge(t, {"wrong_answers": 0, "max_rel_gap": 1e-12}, 0)
    assert ok and list(checks) == ["failed_queries", "wrong_answers", "max_rel_gap"]
    assert not compare.judge(t, {"wrong_answers": 0, "max_rel_gap": 1e-12}, 1)[0]
    t.add("b", [(1.0 + 1e-9,)], [(1,)])
    assert not compare.judge(t, {"wrong_answers": 0, "max_rel_gap": 1e-12}, 0)[0]
    assert not compare.judge(compare.Tally(), {"wrong_answers": 0, "max_rel_gap": 1}, 0)[0]
