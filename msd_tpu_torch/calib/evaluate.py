"""Offline calibrator evaluation — compare_ece_train_val +
benchmark_calibrator_timing analogs (calibrators.py:850-1043, 640-791).

compare_ece_train_val: 80/20 split, fit on train, report pre-calibration
(raw draft confidence) vs post-calibration ECE/Brier/soft-MSE on both splits,
plus per-group reliability tables. benchmark_timing times host predict_proba
and the device table path.

The port of the JAX package's ``calib/evaluate.py``: the device path is
the port's ``calib.device.predict_proba`` over ``CalibTables`` on a torch
device (``torch_device``, the card by default), timed between
synchronizations.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from msd_tpu_torch.calib.grouped import GroupedIsotonicCalibrator


def _split(features: Dict, labels_soft, labels_hard, train_frac=0.8, seed=0):
    n = len(labels_soft)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    cut = int(n * train_frac)
    tr, va = idx[:cut], idx[cut:]

    def take(d, i):
        return {k: np.asarray(v)[i] for k, v in d.items()}

    return (take(features, tr), np.asarray(labels_soft)[tr],
            np.asarray(labels_hard)[tr],
            take(features, va), np.asarray(labels_soft)[va],
            np.asarray(labels_hard)[va])


def compare_ece_train_val(features: Dict, soft_labels, hard_labels, *,
                          train_frac: float = 0.8,
                          min_samples_per_group: int = 100,
                          max_grouping_level: int = 2,
                          target: str = "soft", seed: int = 0) -> Dict:
    ftr, str_, htr, fva, sva, hva = _split(features, soft_labels, hard_labels,
                                           train_frac, seed)
    cal = GroupedIsotonicCalibrator(
        min_samples_per_group=min_samples_per_group,
        max_grouping_level=max_grouping_level, target=target).fit(
            ftr, str_, htr)

    out = {}
    for name, f, s, h in (("train", ftr, str_, htr), ("val", fva, sva, hva)):
        raw = np.asarray(f["draft_confidence"], float)
        pre = {
            "ece_eqfreq20": cal.ece(raw, h, 20, True),
            "ece_fixed10": cal.ece(raw, h, 10, False),
            "brier": float(np.mean((raw - h) ** 2)),
            "soft_mse": float(np.mean((raw - s) ** 2)),
        }
        post = cal.evaluate(f, s, h)
        out[name] = {"pre": pre, "post": post,
                     "delta_ece": pre["ece_eqfreq20"] - post["ece_eqfreq20"]}
    out["n_train"], out["n_val"] = len(str_), len(sva)
    out["calibrator"] = cal
    return out


def benchmark_calibrator_timing(cal: GroupedIsotonicCalibrator,
                                features: Dict, *, repeats: int = 5,
                                vocab_size: int = 32000,
                                device: bool = True,
                                torch_device="cuda") -> Dict:
    n = len(np.asarray(features["draft_confidence"]))
    best_host = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        cal.predict_proba(features)
        best_host = min(best_host, time.perf_counter() - t0)
    out = {"n": n, "host_predict_s": best_host,
           "host_us_per_candidate": best_host / max(n, 1) * 1e6}

    if device:
        import torch

        from msd_tpu_torch.calib.device import CalibTables, predict_proba
        from msd_tpu_torch.calib.token_class import synthetic_vocab_table

        dev = torch.device(torch_device)
        ct = CalibTables.from_host(cal.export_tables(),
                                   synthetic_vocab_table(vocab_size),
                                   device=dev)

        def f32(key):
            return torch.from_numpy(
                np.asarray(features[key], np.float32)).to(dev)

        args = (torch.zeros((n,), dtype=torch.int32, device=dev),
                f32("draft_confidence"),
                f32("avg_visual_attention_intensity"),
                torch.from_numpy(np.asarray(features["tree_depth"],
                                            np.int32)).to(dev),
                f32("draft_margin"))

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        predict_proba(ct, *args)
        sync()
        best_dev = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            predict_proba(ct, *args)
            sync()
            best_dev = min(best_dev, time.perf_counter() - t0)
        out["device_predict_s"] = best_dev
        out["device_us_per_candidate"] = best_dev / max(n, 1) * 1e6
    return out
