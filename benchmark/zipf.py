"""Bounded Zipf sampler (rejection-inversion, Hormann & Derflinger 1996):
values in [1, n] with exponent q, as the reference fork's
benchmark/micro/succinct/zipf.cpp draws them.

A copy of the NumPy path of adacom_tpu_torch/bench/zipf.py, so that the
benchmark's traffic does not depend on the program under test."""

from __future__ import annotations

import numpy as np

_EPS = 1e-8


def _expxm1bx(x):
    small = np.abs(x) <= _EPS
    safe = np.where(small, 1.0, x)
    return np.where(small, 1.0 + x / 2.0 * (1.0 + x / 3.0 * (1.0 + x / 4.0)),
                    np.expm1(safe) / safe)


def _log1pxbx(x):
    small = np.abs(x) <= _EPS
    safe = np.where(small, 1.0, x)
    return np.where(small, 1.0 - x * (0.5 - x * (1 / 3.0 - x * 0.25)),
                    np.log1p(safe) / safe)


class ZipfSampler:
    def __init__(self, n: int, q: float, rng: np.random.Generator):
        self.n = n
        self.q = q
        self.rng = rng
        self.H_x1 = self._H(np.asarray(1.5)) - 1.0
        self.H_n = self._H(np.asarray(n + 0.5))

    def _H(self, x):
        log_x = np.log(x)
        return _expxm1bx((1.0 - self.q) * log_x) * log_x

    def _h(self, x):
        return np.exp(-self.q * np.log(x))

    def _H_inv(self, x):
        t = np.clip(x * (1.0 - self.q), -1.0, None)
        return np.exp(_log1pxbx(t) * x)

    def sample(self, size: int) -> np.ndarray:
        out = np.empty(size, dtype=np.int64)
        filled = 0
        while filled < size:
            k = (size - filled) * 2 + 16
            u = self.rng.uniform(self.H_x1, self.H_n, size=k)
            x = self._H_inv(u)
            cand = np.clip(np.round(x), 1, self.n).astype(np.int64)
            accept = u >= (self._H(cand + 0.5) - self._h(cand))
            good = cand[accept]
            take = min(len(good), size - filled)
            out[filled:filled + take] = good[:take]
            filled += take
        return out
