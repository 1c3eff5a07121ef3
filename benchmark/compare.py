"""The comparison that decides `correct`.

An answer is a list of rows. It is wrong when its number of rows, a row's
width, or a value that is not a number (a string, NULL) differs from the
reference's. Every number is held against the reference's by its relative
gap, |got - want| / |want| (the absolute gap where want is 0), taken
exactly: the reference's values are exact integers or fractions, the
program's are converted without rounding."""

from __future__ import annotations

from fractions import Fraction
from numbers import Number

import numpy as np


def _exact(x):
    if isinstance(x, (bool, np.bool_)):
        return int(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, Fraction):
        return x
    return Fraction(float(x))


def _is_number(x) -> bool:
    return isinstance(x, (Number, np.number)) and not isinstance(x, (bool, np.bool_))


def value_gap(got, want) -> float:
    """Relative gap of one number; inf where got is no finite number."""
    if not _is_number(got):
        return float("inf")
    if isinstance(got, (float, np.floating)) and not np.isfinite(got):
        return float("inf")
    g, w = _exact(got), _exact(want)
    if g == w:
        return 0.0
    return float(abs(g - w) / (abs(w) if w != 0 else 1))


def answer_gap(got: list, want: list):
    """(wrong, gap) of one answer: wrong is True where a row count, a width
    or a non-number differs; gap is the largest relative gap of a number."""
    if len(got) != len(want):
        return True, 0.0
    gap = 0.0
    for grow, wrow in zip(got, want):
        if len(grow) != len(wrow):
            return True, gap
        for g, w in zip(grow, wrow):
            if _is_number(w):
                gap = max(gap, value_gap(g, w))
            elif g != w:
                return True, gap
    return False, gap


class Tally:
    """The numbers compared over a run's answers."""

    def __init__(self):
        self.answers = 0
        self.wrong = 0
        self.max_rel_gap = 0.0
        self.first_wrong = None  # (label, got, want) of the first wrong answer
        self.widest = None  # the same of the widest gap

    def add(self, label, got, want):
        wrong, gap = answer_gap(got, want)
        self.answers += 1
        self.wrong += int(wrong)
        if wrong and self.first_wrong is None:
            self.first_wrong = (label, got[:3], want[:3])
        if gap > self.max_rel_gap:
            self.widest = (label, got[:3], want[:3])
        self.max_rel_gap = max(self.max_rel_gap, gap)


def judge(tally: Tally, limits: dict, failed: int) -> tuple:
    """(correct, checks): each number compared beside its limit."""
    checks = {
        "failed_queries": [failed, 0],
        "wrong_answers": [tally.wrong, limits["wrong_answers"]],
        "max_rel_gap": [tally.max_rel_gap, limits["max_rel_gap"]],
    }
    correct = tally.answers > 0 and all(v <= lim for v, lim in checks.values())
    return correct, checks
