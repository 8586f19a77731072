"""Grouped isotonic calibrator: host-side fit, exportable to device tables.

The port's own copy of the JAX package's ``calib/grouped.py``: the fit,
the host prediction and the table export. Its metrics (``ece``,
``evaluate``) and pickling serve the offline reports and come with them.

Faithful rebuild of EAGLE/eagle/model/calibrators.py:
- Feature pipeline (:46-101): token_category -> token_type {content:0,
  func_punct:1, number:2}; visual-attention intensity -> quintile bins
  attn_q (quantiles learned at fit); tree_depth -> pos_bin = depth > 2;
  draft_margin -> tercile bins margin_q.
- Hierarchical isotonic fits (:384-438): global fallback + L1(token_type,3) +
  L2(x attn_q,15) + L3(x pos_bin,30) + L4(x margin_q,90); each level fit only
  when >= min_samples_per_group.
- predict walks L{max_grouping_level} -> ... -> L1 -> global -> global mean
  (:442-554), NaN/range-guarded, output clipped to [1e-4, 1-1e-4].
- Soft label = min(1, p_base/p_draft) — the speculative acceptance probability
  (:556-584 load_calibration_data).

``export_tables`` resolves the fallback chain per finest group and samples the
winning isotonic fit at B confidence breakpoints -> a dense [3,5,2,3,B] fp32
table for device-side lookup (no sklearn/pandas in the decode hot path).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from msd_tpu_torch.calib.isotonic import IsotonicRegression

TOKEN_CATEGORIES = ("content", "func_punct", "number")
N_TOKEN, N_ATTN, N_POS, N_MARGIN = 3, 5, 2, 3
CLIP_LO, CLIP_HI = 1e-4, 1.0 - 1e-4


def soft_labels_from(p_base: np.ndarray, p_draft: np.ndarray) -> np.ndarray:
    """Acceptance probability min(1, p_base/p_draft)."""
    return np.minimum(1.0, np.asarray(p_base) / np.maximum(np.asarray(p_draft), 1e-12))


@dataclass
class GroupedIsotonicCalibrator:
    min_samples_per_group: int = 100
    target: str = "hard"            # 'hard' or 'soft'
    max_grouping_level: int = 2     # production default (calibrators.py:829)

    attn_quantiles: Optional[np.ndarray] = None
    margin_quantiles: Optional[np.ndarray] = None
    global_calibrator: Optional[IsotonicRegression] = None
    global_mean: float = 0.5
    levels: Dict[int, Dict[str, Optional[IsotonicRegression]]] = field(
        default_factory=dict)
    is_fitted: bool = False

    # ---------------- features ----------------
    def _token_type(self, token_category) -> np.ndarray:
        cmap = {c: i for i, c in enumerate(TOKEN_CATEGORIES)}
        return np.asarray([cmap.get(c, 0) for c in token_category], np.int64)

    def _bin(self, x: np.ndarray, quantiles: np.ndarray) -> np.ndarray:
        return np.searchsorted(quantiles, x, side="left").astype(np.int64)

    def _preprocess(self, features: Dict, fit_mode: bool = False) -> Dict:
        out = {}
        out["token_type"] = self._token_type(features["token_category"])
        attn = np.asarray(features["avg_visual_attention_intensity"], np.float64)
        if fit_mode:
            self.attn_quantiles = np.quantile(attn, [0.2, 0.4, 0.6, 0.8])
        out["attn_q"] = self._bin(attn, self.attn_quantiles)
        depth = np.asarray(features["tree_depth"], np.float64)
        out["pos_bin"] = (depth > 2).astype(np.int64)
        if "draft_margin" in features:
            margin = np.asarray(features["draft_margin"], np.float64)
            if fit_mode or self.margin_quantiles is None:
                self.margin_quantiles = np.quantile(margin, [0.33, 0.67])
            out["margin_q"] = self._bin(margin, self.margin_quantiles)
        else:
            out["margin_q"] = np.zeros_like(out["attn_q"])
        out["draft_conf"] = np.asarray(features["draft_confidence"], np.float64)
        return out

    @staticmethod
    def _key(*idx) -> str:
        tags = "tapm"
        return "_".join(f"{tags[i]}{v}" for i, v in enumerate(idx))

    # ---------------- fit / predict ----------------
    def fit(self, features: Dict, soft_labels: np.ndarray,
            hard_labels: np.ndarray,
            sample_weights: Optional[np.ndarray] = None):
        proc = self._preprocess(features, fit_mode=True)
        c = proc["draft_conf"]
        y = np.asarray(hard_labels if self.target == "hard" else soft_labels,
                       np.float64)
        w = sample_weights

        def iso(idx_mask):
            wi = w[idx_mask] if w is not None else None
            return IsotonicRegression().fit(c[idx_mask], y[idx_mask], wi)

        self.global_calibrator = iso(np.ones_like(c, bool))
        self.global_mean = float(np.average(y, weights=w) if w is not None
                                 else np.mean(y))

        dims = [proc["token_type"], proc["attn_q"], proc["pos_bin"],
                proc["margin_q"]]
        sizes = [N_TOKEN, N_ATTN, N_POS, N_MARGIN]
        self.levels = {1: {}, 2: {}, 3: {}, 4: {}}
        for level in (1, 2, 3, 4):
            for combo in np.ndindex(*sizes[:level]):
                mask = np.ones_like(c, bool)
                for d, v in zip(dims, combo):
                    mask &= d == v
                key = self._key(*combo)
                self.levels[level][key] = (
                    iso(mask) if mask.sum() >= self.min_samples_per_group
                    else None)
        self.is_fitted = True
        return self

    def _resolve(self, *combo) -> Optional[IsotonicRegression]:
        """Fallback chain for a finest-group combo at max_grouping_level."""
        for level in range(min(self.max_grouping_level, 4), 0, -1):
            cal = self.levels.get(level, {}).get(self._key(*combo[:level]))
            if cal is not None:
                return cal
        return self.global_calibrator

    def predict_proba(self, features: Dict) -> np.ndarray:
        proc = self._preprocess(features, fit_mode=False)
        c = proc["draft_conf"]
        valid = np.isfinite(c) & (c >= 0.0) & (c <= 1.0)
        out = np.full_like(c, self.global_mean, np.float64)
        combos = np.stack([proc["token_type"], proc["attn_q"],
                           proc["pos_bin"], proc["margin_q"]], axis=1)
        lvl = min(self.max_grouping_level, 4)
        uniq = np.unique(combos[:, :lvl], axis=0) if len(c) else []
        for u in uniq:
            mask = np.all(combos[:, :lvl] == u, axis=1) & valid
            if not mask.any():
                continue
            full = tuple(u) + (0,) * (4 - lvl)
            cal = self._resolve(*full)
            out[mask] = (cal.predict(c[mask]) if cal is not None
                         else self.global_mean)
        out = np.nan_to_num(out, nan=self.global_mean, posinf=1.0, neginf=0.0)
        return np.clip(out, CLIP_LO, CLIP_HI)

    # ---------------- device export ----------------
    def export_tables(self, n_breakpoints: int = 512) -> Dict[str, np.ndarray]:
        """Dense lookup tables for device-side prediction.

        table[t, a, p, m, b] = clip(resolved_calibrator(conf_b)) at
        conf_b = b / (B-1). Device predict = gather by group indices + linear
        interpolation over b — exactly what predict_proba computes, minus
        host round-trips.
        """
        assert self.is_fitted
        B = n_breakpoints
        conf = np.linspace(0.0, 1.0, B)
        table = np.empty((N_TOKEN, N_ATTN, N_POS, N_MARGIN, B), np.float32)
        for combo in np.ndindex(N_TOKEN, N_ATTN, N_POS, N_MARGIN):
            lvl = min(self.max_grouping_level, 4)
            cal = self._resolve(*(combo[:lvl] + (0,) * (4 - lvl)))
            vals = (cal.predict(conf) if cal is not None
                    else np.full(B, self.global_mean))
            table[combo] = np.clip(vals, CLIP_LO, CLIP_HI)
        return {
            "table": table,
            "attn_quantiles": np.asarray(self.attn_quantiles, np.float32),
            "margin_quantiles": np.asarray(self.margin_quantiles, np.float32),
            "global_mean": np.float32(self.global_mean),
        }
