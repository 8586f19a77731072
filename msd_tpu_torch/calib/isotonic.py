"""Isotonic regression via pool-adjacent-violators (PAV), numpy only.

The port's own copy of the JAX package's ``calib/isotonic.py`` (the port
imports nothing of that package); same names, same arithmetic.

Drop-in for the sklearn IsotonicRegression the reference uses
(EAGLE/eagle/model/calibrators.py:265-269): increasing fit on
(confidence, label) pairs with optional sample weights; prediction linearly
interpolates between the fitted thresholds and clips out-of-bounds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class IsotonicRegression:
    increasing: bool = True
    out_of_bounds: str = "clip"
    x_thresholds_: Optional[np.ndarray] = field(default=None, repr=False)
    y_thresholds_: Optional[np.ndarray] = field(default=None, repr=False)

    def fit(self, x: np.ndarray, y: np.ndarray,
            sample_weight: Optional[np.ndarray] = None) -> "IsotonicRegression":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        w = np.ones_like(x) if sample_weight is None else \
            np.asarray(sample_weight, np.float64)
        order = np.argsort(x, kind="stable")
        x, y, w = x[order], y[order], w[order]
        if not self.increasing:
            y = -y

        # merge duplicate x by weighted mean (secondary averaging)
        ux, inv = np.unique(x, return_inverse=True)
        wsum = np.bincount(inv, weights=w)
        ysum = np.bincount(inv, weights=w * y)
        ym = ysum / wsum

        yhat = _pav(ym, wsum)

        if not self.increasing:
            yhat = -yhat
        self.x_thresholds_ = ux
        self.y_thresholds_ = yhat
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        if self.x_thresholds_ is None:
            raise ValueError("not fitted")
        x = np.asarray(x, np.float64)
        xt, yt = self.x_thresholds_, self.y_thresholds_
        if len(xt) == 1:
            return np.full_like(x, yt[0], dtype=np.float64)
        out = np.interp(x, xt, yt)  # np.interp clips at the ends
        if self.out_of_bounds == "nan":
            out = np.where((x < xt[0]) | (x > xt[-1]), np.nan, out)
        return out


def _pav(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Pool adjacent violators for an increasing fit. O(n)."""
    n = len(y)
    # block representation: value, weight, count
    vals = np.empty(n)
    wts = np.empty(n)
    cnts = np.empty(n, dtype=np.int64)
    m = 0  # number of blocks
    for i in range(n):
        vals[m] = y[i]
        wts[m] = w[i]
        cnts[m] = 1
        m += 1
        while m > 1 and vals[m - 2] >= vals[m - 1]:
            tot = wts[m - 2] + wts[m - 1]
            vals[m - 2] = (vals[m - 2] * wts[m - 2] + vals[m - 1] * wts[m - 1]) / tot
            wts[m - 2] = tot
            cnts[m - 2] += cnts[m - 1]
            m -= 1
    return np.repeat(vals[:m], cnts[:m])
