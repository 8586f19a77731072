"""The port's eval harness (``msd_tpu_torch.harness``, ``calib/logger.py``,
``calib/evaluate.py`` and the calibrator's metrics and pickle) against the
JAX package's, on the CPU.

Host-only modules (metrics, filters, tasks) must give the JAX package's
answers on the same inputs, fixed and drawn by hypothesis. The adapters
run on one set of tiny fp32 weights carried across (the serving tests'
stack): ``evaluate`` on ``synthetic_vqa``, ``pope`` and ``ai2d_ppl`` gives
JAX's responses, loglikelihoods (1e-4 relative) and ``msd_stats``, the AR
adapter the MSD adapter's responses, and the online calibration phases
JAX's collected rows (within 1e-5, as the calibration tests hold them),
tables and calibrated responses, also when either package's calibrator
pickle is read by the other. The
CLI (``python -m msd_tpu_torch.harness``) runs a random tiny stack on the
CPU (``--device cpu``).
"""

import json
import os
import sqlite3

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from msd_tpu.calib import evaluate as JCE
from msd_tpu.calib import grouped as JG
from msd_tpu.harness import __main__ as JMain
from msd_tpu.harness import evaluator as JEv
from msd_tpu.harness import filters as JF
from msd_tpu.harness import metrics as JM
from msd_tpu.harness import registry as JR
from msd_tpu.harness import tasks as JT
from msd_tpu.harness.models.llava_msd import LlavaAR as JLlavaAR
from msd_tpu.harness.models.llava_msd import LlavaMSD as JLlavaMSD
from msd_tpu.harness.models.llava_msd import SimpleTokenizer as JTok
from msd_tpu.models import llava as JV
from msd_tpu_torch.calib import evaluate as TCE
from msd_tpu_torch.calib import grouped as TG
from msd_tpu_torch.calib.token_class import synthetic_vocab_table
from msd_tpu_torch.harness import __main__ as TMain
from msd_tpu_torch.harness import evaluator as TEv
from msd_tpu_torch.harness import filters as TF
from msd_tpu_torch.harness import metrics as TM
from msd_tpu_torch.harness import registry as TR
from msd_tpu_torch.harness import tasks as TT
from msd_tpu_torch.harness.cache import CachingLM
from msd_tpu_torch.harness.models.llava_msd import (LlavaAR, LlavaMSD,
                                                    SimpleTokenizer)
from tests.test_torch_anyres_multi import jax_native
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_serve import MEDUSA, V, _lcfgs, _stack

RTOL = 1e-4
TASKS = ["synthetic_vqa", "pope", "ai2d_ppl"]
GEN_KW = {"max_new_tokens": 12}


# ---------------------------------------------------------------------------
# metrics and filters
# ---------------------------------------------------------------------------

TEXTS = ["", "Yes.", "no", "The answer is (B).", "C) option 2", "3.14",
         "12%", "two dogs", "It's a cat!", "[0.1, 0.2, 0.6, 0.9]",
         "#### -1,234.5", "a\tb\nc", "A", "none of the above"]
METRIC_CASES = {
    "relaxed_correctness": [(p, t) for p in TEXTS[:8]
                            for t in ("3.1", "12", "no", "0")],
    "vqa_normalize": [(t,) for t in TEXTS],
    "vqa_accuracy": [(p, a) for p in TEXTS[:6]
                     for a in (["yes"] * 10, ["no", "yes", "2"], ["two"])],
    "anls": [(p, a) for p in TEXTS[:8] for a in (["yes"], ["3.14", "pi"])],
    "normalize_extract": [(t,) for t in TEXTS],
    "exact_match": [(p, t) for p in TEXTS[:8] for t in ("yes", "3.14")],
    "extract_choice": [(t, n) for t in TEXTS for n in (4, 8)],
    "mc_accuracy": [(p, t) for p in TEXTS for t in ("A", "B", "C")],
    "mean": [([],), ([1.0, 0.0, 0.5],)],
    "bootstrap_stderr": [([1.0],), ([0.0, 1.0] * 20,), ([0.2, 0.9, 0.4],)],
    "parse_box": [(t,) for t in TEXTS],
    "box_iou": [([0, 0, 1, 1], [0.5, 0.5, 2, 2]), ([0, 0, 1, 1], [2, 2, 3, 3]),
                ([0, 0, 0, 0], [0, 0, 0, 0])],
    "box_center_in": [([0, 0, 1, 1], [0.2, 0.2, 0.4, 0.4]),
                      ([0, 0, 1, 1], [0.9, 0.9, 2, 2])],
}


@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_metric_matches_jax(name):
    for args in METRIC_CASES[name]:
        assert getattr(TM, name)(*args) == getattr(JM, name)(*args), args


@pytest.mark.parametrize("name", ["relaxed_correctness", "vqa_accuracy",
                                  "anls", "exact_match", "mc_accuracy"])
@settings(max_examples=60, deadline=None)
@given(pred=st.text(max_size=12), target=st.text(max_size=12))
def test_metric_matches_jax_on_drawn_text(name, pred, target):
    arg = [target, target.upper()] if name in ("vqa_accuracy", "anls") \
        else target
    assert getattr(TM, name)(pred, arg) == getattr(JM, name)(pred, arg)


@pytest.mark.parametrize("name", ["vqa_normalize", "normalize_extract",
                                  "extract_choice", "parse_box"])
@settings(max_examples=60, deadline=None)
@given(text=st.text(max_size=24))
def test_unary_metric_matches_jax_on_drawn_text(name, text):
    assert getattr(TM, name)(text) == getattr(JM, name)(text)


CHOICES = (None, ["A. red", "B. blue", "C. green"], ["cat", "dog"])
FILTER_CASES = {
    "take_first": lambda m, t: m.take_first([t, "x"]),
    "regex": lambda m, t: m.RegexFilter()(t),
    "regex_custom": lambda m, t: m.RegexFilter(r"(\d+)\s*(apples)?", 0,
                                               "none")(t),
    "multi_choice": lambda m, t: m.MultiChoiceRegexFilter()(t),
    "multi_choice_with_choices": lambda m, t: [
        m.MultiChoiceRegexFilter().filter_with_choices(t, c)
        for c in CHOICES],
    "whitespace": lambda m, t: m.WhitespaceFilter()(t),
    "chain": lambda m, t: m.chain(m.WhitespaceFilter(),
                                  m.MultiChoiceRegexFilter())(t),
}


@pytest.mark.parametrize("name", sorted(FILTER_CASES))
def test_filter_matches_jax(name):
    fn = FILTER_CASES[name]
    for t in TEXTS + ["I pick blue", "cats and dogs", "#### 42", "12 apples"]:
        assert fn(TF, t) == fn(JF, t), t


@pytest.mark.parametrize("name", sorted(FILTER_CASES))
@settings(max_examples=40, deadline=None)
@given(text=st.text(max_size=24))
def test_filter_matches_jax_on_drawn_text(name, text):
    fn = FILTER_CASES[name]
    assert fn(TF, text) == fn(JF, text)


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------

def _registered(registry, register, env=None):
    """The tasks ``register()`` puts into ``registry`` (a fresh one; the
    registry's entries are restored after), under ``env`` alone of the
    two task-directory variables."""
    saved = dict(registry)
    registry.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MSD_TPU_DATASETS", raising=False)
        mp.delenv("MSD_TPU_TASKS", raising=False)
        for k, v in (env or {}).items():
            mp.setenv(k, v)
        register()
        out = dict(registry)
    registry.clear()
    registry.update(saved)
    return out


def _builtin_pairs():
    """(port task, JAX task) by name: every task JAX's tasks.py
    registers, its task modules' included."""
    mine = _registered(TR.TASK_REGISTRY, TT.register_builtin_tasks)
    theirs = _registered(JR.TASK_REGISTRY, JT.register_builtin_tasks)
    return mine, theirs


MINE, THEIRS = _builtin_pairs()


def test_builtin_tasks_are_jax_tasks_py_tasks():
    assert sorted(MINE) == sorted(THEIRS)
    assert len(MINE) == 160
    assert {"synthetic_vqa", "pope", "ai2d_ppl", "gsm8k", "mmlu",
            "mme_realworld_lite", "llava_in_the_wild", "mmbench_cn_cc",
            "mmivqd_instruction", "gqa_ru", "mmvetv2", "activitynetqa",
            "ifeval", "olympiadbench_test_en", "vitatecs_direction",
            "wildvision_0617", "llava_interleave_bench",
            "librispeech_test_clean", "air_bench_chat", "live_bench",
            "vdc_camera_test", "mmsearch_end2end"} <= set(MINE)


def _same_value(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_value(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_value(x, y)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


RESPONSES = ["A", "yes", "No.", "2", "The answer is 4.", "value 2",
             "[0.1, 0.2, 0.3, 0.5]", "a photo of object 1", "#### 4"]


@pytest.mark.parametrize("name", sorted(MINE))
def test_builtin_task_matches_jax(name):
    """On the synthetic docs: the same docs, contexts, visuals, requests
    and gen_kwargs; process_results on fixed responses and aggregate equal
    JAX's."""
    mine, theirs = MINE[name], THEIRS[name]
    for attr in ("name", "split", "gen_kwargs", "metric_names",
                 "output_type", "dataset_path", "scoring_deviation"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    docs, jdocs = mine.load_docs(limit=3), theirs.load_docs(limit=3)
    assert mine.used_synthetic_docs and theirs.used_synthetic_docs
    _same_value(docs, jdocs)
    for d in docs:
        assert mine.doc_to_text(d) == theirs.doc_to_text(d)
        _same_value(mine.doc_to_visual(d), theirs.doc_to_visual(d))
    reqs = mine.build_requests(docs, num_fewshot=1,
                               gen_kwargs_override={"max_new_tokens": 7})
    jreqs = theirs.build_requests(jdocs, num_fewshot=1,
                                  gen_kwargs_override={"max_new_tokens": 7})
    assert [(r.request_type, r.doc_id, r.idx, r.arguments[0],
             r.arguments[1] if isinstance(r.arguments[1], (str, dict))
             else None) for r in reqs] == \
        [(r.request_type, r.doc_id, r.idx, r.arguments[0],
          r.arguments[1] if isinstance(r.arguments[1], (str, dict))
          else None) for r in jreqs]
    rows, jrows = [], []
    for i, d in enumerate(docs):
        if mine.output_type == "loglikelihood":
            n = sum(r.doc_id == i for r in reqs)
            resps = [(-1.0 - ((i + j) % 3), j == i % 2) for j in range(n)]
        else:
            resps = [RESPONSES[(i + k) % len(RESPONSES)] for k in range(2)]
        rows.append(mine.process_results(d, resps))
        jrows.append(theirs.process_results(d, resps))
    _same_value(rows, jrows)
    _same_value(mine.aggregate(rows), theirs.aggregate(jrows))


def assert_same_yaml_task(mine, theirs):
    """A YAML task of the port against JAX's from the same file: fields,
    docs, contexts, visuals, targets, scores and aggregate."""
    for attr in ("name", "split", "gen_kwargs", "metric_names",
                 "output_type", "dataset_path"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    docs, jdocs = mine.load_docs(), theirs.load_docs()
    assert not mine.used_synthetic_docs and not theirs.used_synthetic_docs
    _same_value(docs, jdocs)
    rows, jrows = [], []
    for d, resp in zip(docs, ["red", "Red.", "blue", ""] * len(docs)):
        assert mine.doc_to_text(d) == theirs.doc_to_text(d)
        _same_value(mine.doc_to_visual(d), theirs.doc_to_visual(d))
        assert mine.doc_to_target(d) == theirs.doc_to_target(d)
        rows.append(mine.process_results(d, [resp]))
        jrows.append(theirs.process_results(d, [resp]))
    _same_value(rows, jrows)
    _same_value(mine.aggregate(rows), theirs.aggregate(jrows))


@pytest.mark.parametrize("var", ["MSD_TPU_TASKS", "MSD_TPU_DATASETS"])
def test_task_dirs_of_the_later_slice_raise(tmp_path, var):
    """A YAML task directory ($MSD_TPU_TASKS, or tasks/ under the dataset
    root), which the port refused until it took yaml_task.py, now
    registers its tasks in both packages alike (the name is kept from
    then)."""
    import chip_smoke

    chip_smoke.write_yaml_task(str(tmp_path / "tasks"), 3)
    env = {var: str(tmp_path / "tasks" if var == "MSD_TPU_TASKS"
                    else tmp_path)}
    name = chip_smoke.HARNESS_EXT_YAML
    mine = _registered(TR.TASK_REGISTRY, TT.register_builtin_tasks, env)
    theirs = _registered(JR.TASK_REGISTRY, JT.register_builtin_tasks, env)
    assert sorted(mine) == sorted(theirs) == sorted(set(MINE) | {name})
    assert_same_yaml_task(mine[name], theirs[name])


# ---------------------------------------------------------------------------
# the calibrator's metrics and pickle, the logger, the offline reports
# ---------------------------------------------------------------------------

def _fake(n, seed):
    rng = np.random.default_rng(seed)
    feats = {
        "token_category": rng.choice(["content", "func_punct", "number"], n),
        "avg_visual_attention_intensity": rng.uniform(size=n),
        "tree_depth": rng.integers(1, 7, n).astype(float),
        "draft_margin": rng.uniform(size=n),
        "draft_confidence": rng.uniform(size=n),
    }
    soft = np.clip(feats["draft_confidence"] + rng.normal(0, 0.1, n), 0, 1)
    hard = (rng.uniform(size=n) < soft).astype(float)
    return feats, soft, hard


def _fitted(mod, seed=0):
    feats, soft, hard = _fake(900, seed)
    return mod.GroupedIsotonicCalibrator(min_samples_per_group=50,
                                         target="soft").fit(feats, soft,
                                                            hard)


def _same_tables(a, b):
    ea, eb = a.export_tables(64), b.export_tables(64)
    assert ea.keys() == eb.keys()
    for k in ea:
        np.testing.assert_array_equal(ea[k], eb[k], err_msg=k)


@pytest.mark.parametrize("equal_freq", [True, False])
def test_calibrator_ece_and_evaluate_match_jax(equal_freq):
    mine, theirs = _fitted(TG), _fitted(JG)
    feats, soft, hard = _fake(300, 1)
    p = mine.predict_proba(feats)
    assert mine.ece(p, hard, 20, equal_freq) == \
        theirs.ece(p, hard, 20, equal_freq)
    assert mine.evaluate(feats, soft, hard) == \
        theirs.evaluate(feats, soft, hard)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_calibrator_pickle_reads_in_both_packages(writer, tmp_path):
    """A pickle written by either package loads in both, with the tables
    of the calibrator that wrote it; the port's ``load`` gives the port's
    class without importing the JAX package's classes."""
    cal = _fitted(TG if writer == "port" else JG)
    path = str(tmp_path / "cal.pkl")
    cal.save(path)
    mine, theirs = TG.GroupedIsotonicCalibrator.load(path), \
        JG.GroupedIsotonicCalibrator.load(path)
    assert type(mine) is TG.GroupedIsotonicCalibrator
    assert type(mine.global_calibrator).__module__ == \
        "msd_tpu_torch.calib.isotonic"
    _same_tables(mine, cal)
    _same_tables(theirs, cal)


def test_compare_ece_train_val_matches_jax():
    feats, soft, hard = _fake(1200, 2)
    mine = TCE.compare_ece_train_val(feats, soft, hard,
                                     min_samples_per_group=60)
    theirs = JCE.compare_ece_train_val(feats, soft, hard,
                                       min_samples_per_group=60)
    _same_tables(mine.pop("calibrator"), theirs.pop("calibrator"))
    assert mine == theirs


def test_benchmark_calibrator_timing_reports_jax_keys():
    cal = _fitted(TG)
    feats, _, _ = _fake(500, 3)
    mine = TCE.benchmark_calibrator_timing(cal, feats, repeats=2,
                                           vocab_size=V, torch_device="cpu")
    theirs = JCE.benchmark_calibrator_timing(_fitted(JG), feats, repeats=2,
                                             vocab_size=V)
    assert mine.keys() == theirs.keys() and mine["n"] == theirs["n"] == 500
    assert mine["device_predict_s"] > 0


# ---------------------------------------------------------------------------
# the adapters through evaluate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stack():
    """make(port class, JAX class, **kw) -> the two adapters over one set
    of tiny weights. Both adapters' images go through their packages'
    default (native C++) image prep."""
    jax_native()
    jgen, tgen, jlp, tlp = _stack(MEDUSA, medusa_heads=4)
    jl, tl = _lcfgs()
    enc = jax.jit(lambda px: JV.encode_image(jlp, jl, px))
    TR.TASK_REGISTRY.update(MINE)
    if not JR.TASK_REGISTRY:
        JT.register_builtin_tasks()

    def make(cls, jcls, **kw):
        vc = synthetic_vocab_table(V)
        return (cls.from_llava(tgen, SimpleTokenizer(V), tlp, tl,
                               vocab_class=vc, **kw),
                jcls(jgen, JTok(V), enc, image_size=28, vocab_class=vc,
                     **kw))

    return make


def _responses(out, task):
    return [s["response"] for s in out["details"][task]["samples"]]


def _evaluate(lm, tasks=TASKS, limit=4):
    ev = TEv if isinstance(lm, LlavaMSD) else JEv
    return ev.evaluate(lm, tasks, limit=limit, gen_kwargs=GEN_KW)


def _same_scores(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        for (lp, greedy), (jlp, jgreedy) in zip(a, b):
            assert lp == pytest.approx(jlp, rel=RTOL)
            assert greedy == jgreedy


@pytest.fixture(scope="module")
def plain_runs(stack):
    """evaluate on the three tasks, MSD and AR adapters of both packages."""
    out = {}
    for kind, (cls, jcls) in {"msd": (LlavaMSD, JLlavaMSD),
                              "ar": (LlavaAR, JLlavaAR)}.items():
        mine, theirs = stack(cls, jcls)
        out[kind] = (_evaluate(mine), _evaluate(theirs))
    return out


@pytest.mark.parametrize("kind", ["msd", "ar"])
@pytest.mark.parametrize("task", TASKS)
def test_evaluate_matches_jax(plain_runs, kind, task):
    """Responses equal JAX's, loglikelihoods to 1e-4 relative with the
    same greedy flags, the same metric keys, synthetic markers and
    msd_stats."""
    mine, theirs = plain_runs[kind]
    if task == "ai2d_ppl":
        _same_scores(_responses(mine, task), _responses(theirs, task))
    else:
        assert _responses(mine, task) == _responses(theirs, task)
    assert mine["results"][task].keys() == theirs["results"][task].keys()
    assert mine["synthetic_tasks"] == theirs["synthetic_tasks"] == TASKS
    assert mine["msd_stats"] == theirs["msd_stats"]


@pytest.mark.parametrize("task", TASKS)
def test_ar_adapter_gives_the_msd_responses(plain_runs, task):
    """Greedy losslessness through the harness: the AR adapter's responses
    and scores equal the MSD adapter's."""
    msd, ar = plain_runs["msd"][0], plain_runs["ar"][0]
    assert _responses(ar, task) == _responses(msd, task)
    assert msd["msd_stats"]["accept_steps"] > 0
    assert ar["msd_stats"]["accept_steps"] == 0


def _multi_round(tmod):
    """A two-round task (tests/test_loglikelihood.py's): round 1 sees round
    0's output, round 2 ends the loop."""
    def doc_to_text(doc, previous_output=None, round_idx=0,
                    previous_round_info=None):
        if round_idx == 0:
            return "Round zero question?"
        if round_idx >= 2:
            return [], "", True, previous_output, previous_round_info
        return ([doc["image"]], f"Follow-up {round_idx}?", False,
                previous_output, {"round": round_idx})

    return tmod.TaskConfig(
        name="mr_test", doc_to_text=doc_to_text,
        doc_to_visual=lambda d: [d["image"]],
        process_results=lambda d, r: {"n_rounds": float(len(r[0]))},
        output_type="generate_until_multi_round",
        gen_kwargs={"max_new_tokens": 12, "temperature": 0.0},
        metric_names=("n_rounds",),
        synthetic_docs=lambda n: [{"image": JT._synth_image(i)}
                                  for i in range(n)])


def test_multi_round_generation_matches_jax(stack):
    mine, theirs = stack(LlavaMSD, JLlavaMSD)
    TR.register_task("mr_test", _multi_round(TT))
    JR.register_task("mr_test", _multi_round(JT))
    a = TEv.evaluate(mine, ["mr_test"], limit=2)
    b = JEv.evaluate(theirs, ["mr_test"], limit=2)
    assert _responses(a, "mr_test") == _responses(b, "mr_test")
    assert a["results"]["mr_test"]["n_rounds"] == 2.0
    assert a["msd_stats"] == b["msd_stats"]


@pytest.mark.parametrize("target", ["blue", "callable"])
def test_loglikelihood_request_matches_jax(stack, target):
    """One loglikelihood request with an image: a string or a callable
    doc_to_target; both packages' (logprob, is_greedy); a longer
    continuation scores lower; a repeat is bitwise equal."""
    from msd_tpu.harness.instance import Instance as JInstance
    from msd_tpu_torch.harness.instance import Instance

    mine, theirs = stack(LlavaMSD, JLlavaMSD)
    doc = {"image": JT._synth_image(0), "answer": "blue"}
    cont = (lambda d: d["answer"]) if target == "callable" else target

    def ll(lm, icls, c):
        req = icls(request_type="loglikelihood", doc=doc,
                   arguments=("Describe.", c, lambda d: [d["image"]], 0, "t",
                              "test"), idx=0, task_name="t", doc_id=0)
        return lm.loglikelihood([req])[0]

    got, want = ll(mine, Instance, cont), ll(theirs, JInstance, cont)
    _same_scores([[got]], [[want]])
    assert ll(mine, Instance, cont) == got
    assert ll(mine, Instance, "blue and also red and green")[0] < got[0]


@pytest.fixture(scope="module")
def calibrated(stack, tmp_path_factory):
    """Online calibration with train_ratio 0.5 over 6 synthetic_vqa docs:
    the first 3 collect, the calibrator is fitted at the boundary and
    pickled, the last 3 decode with calibrated trees."""
    root = tmp_path_factory.mktemp("calib")
    mine, theirs = stack(LlavaMSD, JLlavaMSD, use_calibration=True,
                         train_ratio=0.5, log_dir=str(root / "mine"),
                         calibrator_path=str(root / "mine.pkl"))
    theirs.calibrator_path = str(root / "theirs.pkl")
    theirs.log_dir = str(root / "theirs")
    theirs.calib_logger.save_dir = theirs.log_dir
    return (mine, _evaluate(mine, ["synthetic_vqa"], 6),
            theirs, _evaluate(theirs, ["synthetic_vqa"], 6), root)


def test_calibration_phases_match_jax(calibrated):
    mine, out, theirs, jout, _ = calibrated
    assert len(mine._calib_rows) == len(theirs._calib_rows) == 3
    for row, jrow in zip(mine._calib_rows, theirs._calib_rows):
        assert row.keys() == jrow.keys()
        for key in ("token_category", "tree_depth", "base_top1"):
            np.testing.assert_array_equal(row[key], jrow[key], err_msg=key)
        for key in ("avg_visual_attention_intensity", "draft_margin",
                    "draft_confidence", "base_conf"):
            np.testing.assert_allclose(row[key], jrow[key], atol=1e-5,
                                       err_msg=key)
    assert _responses(out, "synthetic_vqa") == \
        _responses(jout, "synthetic_vqa")
    assert out["msd_stats"] == jout["msd_stats"]


def test_calibrator_fitted_on_the_same_rows_exports_jax_tables(calibrated):
    _, _, theirs, _, _ = calibrated
    rows = theirs._calib_rows
    feats = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    soft = JG.soft_labels_from(feats.pop("base_conf"),
                               np.maximum(feats["draft_confidence"], 1e-6))
    hard = feats.pop("base_top1").astype(float)
    kw = dict(min_samples_per_group=200, max_grouping_level=2,
              target="soft")
    _same_tables(TG.GroupedIsotonicCalibrator(**kw).fit(feats, soft, hard),
                 JG.GroupedIsotonicCalibrator(**kw).fit(feats, soft, hard))
    _same_tables(theirs.calibrator, TG.GroupedIsotonicCalibrator(**kw).fit(
        feats, soft, hard))


def test_run_outputs_match_jax(calibrated):
    """acceptance_rate.json and calibration_data.json: JAX's keys and
    values (meta aside; floats within 1e-5)."""
    mine, _, theirs, _, _ = calibrated

    def load(lm, name):
        with open(os.path.join(lm.log_dir, name)) as f:
            return json.load(f)

    acc, jacc = (load(lm, "acceptance_rate.json") for lm in (mine, theirs))
    assert acc.keys() == jacc.keys()
    assert {k: acc[k] for k in mine.msd_stats} == \
        {k: jacc[k] for k in theirs.msd_stats}
    data, jdata = (load(lm, "calibration_data.json")
                   for lm in (mine, theirs))
    assert data.keys() == jdata.keys()
    for key in ("stats", "reliability", "candidates"):
        np.testing.assert_allclose(
            np.asarray(_numbers(data[key]), float),
            np.asarray(_numbers(jdata[key]), float), atol=1e-5, err_msg=key)
    assert _keys(data) == _keys(jdata)


def _numbers(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _numbers(x[k])]
    if isinstance(x, list):
        return [v for e in x for v in _numbers(e)]
    if isinstance(x, str):
        return []
    return [np.nan if x is None else x]


def _keys(x, prefix=""):
    if isinstance(x, dict):
        return sorted(k2 for k in x
                      for k2 in _keys(x[k], f"{prefix}/{k}")) or [prefix]
    return [prefix]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_skip_to_test_reads_either_pickle(calibrated, stack, writer):
    """A fresh adapter of each package given the other's (or its own)
    pickle skips to the test phase: every doc calibrated, the responses of
    the calibrated docs of the online run and equal across packages."""
    _, out, _, _, root = calibrated
    path = str(root / ("mine.pkl" if writer == "port" else "theirs.pkl"))
    mine, theirs = stack(LlavaMSD, JLlavaMSD, use_calibration=True,
                         calibrator_path=path)
    a = _evaluate(mine, ["synthetic_vqa"], 6)
    b = _evaluate(theirs, ["synthetic_vqa"], 6)
    assert mine._calib_rows == [] and mine.calibrator is not None
    assert _responses(a, "synthetic_vqa") == _responses(b, "synthetic_vqa")
    assert _responses(a, "synthetic_vqa")[3:] == \
        _responses(out, "synthetic_vqa")[3:]
    assert a["msd_stats"] == b["msd_stats"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--model", "llava_msd_calibrated", "--model_args", "tiny=true",
       "--device", "cpu"]


def _keys_of(payload):
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in payload.items()}


def test_cli_payload_has_jax_keys(capsys, tmp_path):
    """main over the random tiny stack (each package its own weights): the
    same payload keys and metric keys, printed and written."""
    argv = ["--tasks", "pope,ai2d_ppl", "--limit", "2", "--use_msd",
            "--log_samples", "--gen_kwargs", "max_new_tokens=6"]
    mine = TMain.main(CLI + argv + ["--output_path",
                                    str(tmp_path / "mine.json")])
    theirs = JMain.main(CLI[:4] + argv + ["--output_path",
                                          str(tmp_path / "theirs.json")])
    assert _keys_of(mine) == _keys_of(theirs)
    for t in ("pope", "ai2d_ppl"):
        assert sorted(mine["results"][t]) == sorted(theirs["results"][t])
        assert len(mine["details"][t]["samples"]) == 2
    with open(tmp_path / "mine.json") as f:
        assert json.load(f) == json.loads(json.dumps(mine, default=str))
    assert mine["msd_stats"]["accept_steps"] > 0
    capsys.readouterr()


def test_cli_use_cache_roundtrip(tmp_path, capsys):
    """--use_cache: the second run is served from sqlite (generation and
    scoring) and gives the first run's results."""
    db = str(tmp_path / "resp.sqlite")
    first = TMain.main(CLI + ["--tasks", "pope,ai2d_ppl", "--limit", "3",
                              "--use_cache", db])
    assert sqlite3.connect(db).execute(
        "SELECT COUNT(*) FROM responses").fetchone()[0] == 3 + 3 * 4

    class ExplodingLM:
        rank, world_size = 0, 1

        def generate_until(self, reqs):
            raise AssertionError("generation must be served from cache")

        def loglikelihood(self, reqs):
            raise AssertionError("scoring must be served from cache")

    lm = CachingLM(ExplodingLM(), db, model_tag="llava_msd_calibrated")
    again = TEv.simple_evaluate(model=lm, tasks=["pope", "ai2d_ppl"],
                                limit=3)
    assert lm.cache_hits == 15 and lm.cache_misses == 0
    assert again["results"] == first["results"]
    capsys.readouterr()


def test_cli_cache_requests_modes(tmp_path, capsys):
    db = str(tmp_path / "resp.sqlite")
    argv = CLI + ["--tasks", "pope", "--limit", "2", "--use_cache", db,
                  "--cache_requests", "true"]
    TMain.main(argv)
    reqdir = db + ".requests"
    assert [f for f in os.listdir(reqdir) if f.startswith("requests_pope")]
    TMain.main(argv)
    TMain.main(argv[:-1] + ["delete"])
    assert not os.listdir(reqdir)
    capsys.readouterr()


def test_cli_config_yaml_sweep(tmp_path, capsys):
    """--config with a list of run configs: one payload per entry, in
    order, each with its own tasks and limit."""
    cfg = tmp_path / "sweep.yaml"
    cfg.write_text("- tasks: pope\n  limit: 2\n"
                   "- tasks: docvqa\n  limit: 3\n  log_samples: true\n")
    payloads = TMain.main(CLI + ["--tasks", "ignored", "--config",
                                 str(cfg)])
    assert isinstance(payloads, list) and len(payloads) == 2
    assert list(payloads[0]["results"]) == ["pope"]
    assert len(payloads[1]["details"]["docvqa"]["samples"]) == 3
    capsys.readouterr()


@pytest.mark.parametrize("flag", ["include_path", "judge", "tasks_env"])
def test_cli_flags_of_the_later_slice_raise(flag, monkeypatch, tmp_path,
                                            capsys):
    """--include_path, --judge endpoint:URL and $MSD_TPU_TASKS, which the
    CLI refused until the port took the YAML tasks and the judge, now
    work as the JAX CLI's (the name is kept from then): the YAML task
    registers, is the JAX package's task from the same file and is
    evaluated; the judge is installed (no task here asks it), 'offline'
    clears it and an unknown spec raises ValueError, as in JAX."""
    import chip_smoke
    from msd_tpu.harness import judge as JJ
    from msd_tpu.harness.yaml_task import load_yaml_task
    from msd_tpu_torch.harness import judge as TJ

    name = chip_smoke.HARNESS_EXT_YAML
    ydir = chip_smoke.write_yaml_task(str(tmp_path / "tasks"), 2)
    argv = CLI + ["--limit", "1"]
    if flag == "include_path":
        argv += ["--include_path", ydir, "--tasks", name]
    elif flag == "tasks_env":
        monkeypatch.setenv("MSD_TPU_TASKS", ydir)
        argv += ["--tasks", name]
    else:
        argv += ["--tasks", "pope", "--judge",
                 "endpoint:http://127.0.0.1:1/v1/chat/completions"]
    saved = dict(TR.TASK_REGISTRY)
    TR.TASK_REGISTRY.clear()
    try:
        payload = TMain.main(argv)
        if flag == "judge":
            judge = TJ.get_judge()
            assert isinstance(judge, TJ.EndpointJudge)
            assert judge.url == "http://127.0.0.1:1/v1/chat/completions"
            assert list(payload["results"]) == ["pope"]
            TMain.main(CLI + ["--limit", "1", "--tasks", "pope"])
            assert TJ.get_judge() is None
            for m in (TMain, JMain):
                with pytest.raises(ValueError, match="unknown judge spec"):
                    m.main(CLI + ["--tasks", "pope", "--judge", "garbage"])
        else:
            assert list(payload["results"]) == [name]
            assert "exact_match" in payload["results"][name]
            assert name not in payload.get("synthetic_tasks", ())
            assert_same_yaml_task(
                TR.TASK_REGISTRY[name],
                load_yaml_task(os.path.join(ydir, "smoke_vqa.yaml")))
    finally:
        TJ.set_judge(None)
        JJ.set_judge(None)
        TR.TASK_REGISTRY.clear()
        TR.TASK_REGISTRY.update(saved)
    capsys.readouterr()


@pytest.mark.parametrize("argv", [["--fewshot_as_multiturn"],
                                  ["--batch_size", "4"]])
def test_cli_validation_errors(argv):
    with pytest.raises(SystemExit):
        TMain.main(CLI + ["--tasks", "pope", "--limit", "1"] + argv)


def test_parse_model_args_matches_jax():
    s = "pretrained=/a/b,tiny=true,max_seq_len=1152,base_alpha=0.5,x=,y=no"
    assert TMain.parse_model_args(s) == JMain.parse_model_args(s)
    assert TR.get_model("llava_msd_calibrated") is LlavaMSD
    assert TR.get_model("llava_msd") is LlavaMSD
    assert TR.get_model("llava") is LlavaAR


def test_the_no_jax_test_covers_the_harness():
    """The AST test of tests/test_torch_bridge.py picks the new modules up
    by its rglob."""
    from tests.test_torch_bridge import PORT_FILES, REPO

    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("harness/__main__.py", "harness/evaluator.py",
                "harness/models/llava_msd.py", "harness/tasks.py",
                "harness/task_utils/mathvista.py", "engine/scoring.py",
                "calib/logger.py", "calib/evaluate.py", "harness/judge.py",
                "harness/yaml_task.py", "harness/tasks_ext.py",
                "harness/tasks_judge.py", "harness/tasks_mmbench.py",
                "harness/tasks_mmupd.py", "harness/tasks_ext2.py",
                "harness/tasks_ext3.py", "harness/tasks_judge2.py",
                "harness/tasks_audio.py", "harness/tasks_ext4.py",
                "harness/tasks_mmsearch.py", "harness/task_utils/ifeval.py"):
        assert f"msd_tpu_torch/{mod}" in names, mod


GATHER = """
import json, sys
import torch.distributed as dist
from msd_tpu_torch.harness.evaluator import _gather_metrics
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
rows = [{"acc": float(rank), "n": rank + i, "pred": "text"}
        for i in range(rank + 1)]
print(json.dumps(_gather_metrics(rows, 2)))
dist.destroy_process_group()
"""


def test_gather_metrics_over_two_processes():
    """_gather_metrics across a world of two (gloo on the CPU): every rank
    gets every rank's numeric metrics in rank order; string payloads stay
    local, as in the JAX multi-host gather."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, "-c", GATHER, str(r), port],
                              stdout=subprocess.PIPE, text=True,
                              cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))))
             for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    want = [{"acc": 0.0, "n": 0.0}, {"acc": 1.0, "n": 1.0},
            {"acc": 1.0, "n": 2.0}]
    assert [json.loads(o) for o in outs] == [want, want]
    with pytest.raises(RuntimeError, match="process group"):
        TEv._gather_metrics([{"acc": 1.0}], 2)
