"""The port's task modules of the extended tier (``tasks_ext``,
``tasks_mmbench``, ``tasks_mmupd``, ``tasks_judge``) and its YAML task
loader (``yaml_task``) against the JAX package's, on the CPU.

Port-side counterparts of tests/test_tasks_ext.py, the mmbench part of
tests/test_tasks_round4.py, the mmupd part of tests/test_tasks_round4b.py
and the YAML part of tests/test_tasks_real_schema.py: the same docs and
responses through both packages' makers give the same contexts, visuals,
scores and aggregates (and the values the JAX tests assert); the shared
rules (``can_infer*``, ``_token_f1``, ``mmupd_grade_row``,
``extract_letter`` and the other extraction helpers) equal JAX's on text
drawn by hypothesis. Every task of the four modules is held against JAX's
on its synthetic docs by tests/test_torch_harness.py.
"""

import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from msd_tpu.harness import tasks_ext as JX
from msd_tpu.harness import tasks_judge as JTJ
from msd_tpu.harness import tasks_mmbench as JMB
from msd_tpu.harness import tasks_mmupd as JMU
from msd_tpu.harness import yaml_task as JY
from msd_tpu_torch.harness import tasks_ext as TX
from msd_tpu_torch.harness import tasks_judge as TTJ
from msd_tpu_torch.harness import tasks_mmbench as TMB
from msd_tpu_torch.harness import tasks_mmupd as TMU
from msd_tpu_torch.harness import yaml_task as TY

IMG = np.zeros((8, 8, 3), np.uint8)
VID = np.zeros((4, 8, 8, 3), np.uint8)
MODULES = {"ext": (TX, JX), "mmbench": (TMB, JMB), "mmupd": (TMU, JMU),
           "judge": (TTJ, JTJ)}


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# the JAX tests' docs and responses through both packages
# ---------------------------------------------------------------------------

MME_DOC = {"question": "q",
           "multi-choice options": [f"({c}) o{j}"
                                    for j, c in enumerate("ABCDE")],
           "answer": "E", "category": "Reasoning/OCR",
           "l2-category": "Diagram and Table", "image": IMG}
QBENCH_DOC = {"question": "q", "option0": "Good", "option1": "Bad",
              "option2": "N/A", "option3": "N/A", "correct_choice": 1,
              "image": IMG}
CONBENCH_BASE = {"image_id": "7", "image": IMG}
TEMPCOMPASS_Q = ("Which caption matches the video?\n"
                 "Caption A: a dog runs left\n"
                 "Caption B: a dog runs right")
# case: (module, maker, maker args, [(doc, response list)], the values the
# JAX tests assert of the port's rows: {row index: {key: value}})
CASES = {
    "mme_realworld": ("ext", "make_mme_realworld", (), [
        (MME_DOC, ["The best answer is E"]), (MME_DOC, ["A"]),
        (dict(MME_DOC, **{"multi-choice options": ["(A) red panda",
                                                   "(B) otter"]},
              answer="B", category="Perception"), ["otter"])],
        {0: {"accuracy": 1.0}, 1: {"accuracy": 0.0, "_Reasoning": 0.0},
         2: {"accuracy": 1.0}}),
    "muirbench": ("ext", "make_muirbench", (), [
        ({"question": "q", "options": ["x", "y"], "answer": "B",
          "task": "Ordering", "image_list": [IMG, IMG]}, ["B"])],
        {0: {"accuracy": 1.0}}),
    "websrc": ("ext", "make_websrc", (), [
        ({"question": "q", "answer": "blue shirt", "domain": "shopping",
          "image": IMG}, ["blue shirt"]),
        ({"question": "q", "answer": "5 dollars", "domain": "shopping",
          "image": IMG}, ["the price is 5 dollars"])],
        {0: {"squad_f1": 1.0}}),
    "qbench": ("ext", "make_qbench", (), [
        (QBENCH_DOC, ["B"]), (dict(QBENCH_DOC, correct_choice="Bad"), ["B"]),
        ({"question": "q", "option0": "a", "option1": "b",
          "correct_choice": 0, "image1": IMG, "image2": IMG}, ["A"]),
        ({k: v for k, v in QBENCH_DOC.items() if k != "correct_choice"}
         | {"answer": "totally absent option text"}, ["A"])],
        {0: {"accuracy": 1.0}, 1: {"accuracy": 1.0}, 3: {"accuracy": 0.0}}),
    "longvideobench": ("ext", "make_longvideobench", (), [
        ({"question": "q", "option0": "a", "option1": "b", "option2": "N/A",
          "correct_choice": 1, "video": VID}, ["B."])],
        {0: {"accuracy": 1.0}}),
    "mlvu": ("ext", "make_mlvu", (), [
        ({"question": "q\n(A) a\n(B) b", "answer": "A", "video": VID,
          "task_type": "needle"}, ["A) a"])],
        {0: {"accuracy": 1.0}}),
    "mmlu": ("ext", "make_mmlu", (), [
        ({"question": "q", "choices": ["c0", "c1", "c2", "c3"], "answer": 2,
          "subject": "astronomy"},
         [(-5.0, False), (-4.0, False), (-1.0, True), (-9.0, False)]),
        ({"question": "q", "choices": ["c0", "c1"], "answer": "B"},
         [(-1.0, True), (-2.0, False)])],
        {0: {"accuracy": 1.0}, 1: {"accuracy": 0.0}}),
    "mmlu_pro": ("ext", "make_mmlu_pro", (), [
        ({"question": "q", "options": [f"o{j}" for j in range(10)],
          "answer_index": 9}, ["... so the answer is (J)."]),
        ({"question": "q", "options": [f"o{j}" for j in range(10)],
          "answer_index": 9}, ["the answer is A"])],
        {0: {"exact_match": 1.0}, 1: {"exact_match": 0.0}}),
    "gpqa": ("ext", "make_gpqa", (), [
        ({"question": " q?", "choice1": "a", "choice2": "b", "choice3": "c",
          "choice4": "d", "answer": 0},
         [(-1.0, True), (-2.0, False), (-3.0, False), (-4.0, False)])],
        {0: {"acc": 1.0, "acc_norm": 1.0}}),
    "synthdog": ("ext", "make_synthdog", (), [
        ({"ground_truth": json.dumps(
            {"gt_parse": {"text_sequence": "Hello World"}}), "image": IMG},
         ["hello world"]),
        ({"ground_truth": "abcd", "image": IMG}, ["abcx"])],
        {0: {"edit_distance_acc": 1.0}, 1: {"edit_distance_acc": 0.75}}),
    "naturalbench": ("ext", "make_naturalbench", (), [
        ({"index": i, "question": "q", "question_type": "yes_no",
          "answer": g, "image": IMG}, [p])
        for i, (g, p) in enumerate(zip(["yes", "no", "no", "yes"],
                                       ["yes", "no", "yes", "no"]))] + [
        ({"Index": 4 + i, "question": "q",
          "question_type": "multiple_choice", "image": IMG}, [p])
        for i, p in enumerate(["A", "B", "B", "A"])],
        {0: {"accuracy": 1.0}, 2: {"accuracy": 0.0}, 4: {"accuracy": 1.0}}),
    "mmt": ("ext", "make_mmt", (), [
        ({"question": "q", "A": "a", "B": "b", "C": "", "answer": "B",
          "l2-category": "ocr", "image": IMG}, ["B"])],
        {0: {"accuracy": 1.0}}),
    "ii_bench": ("ext", "make_ii_bench", (), [
        (dict({"question": "q", "answer": "F", "image": IMG},
              **{f"option{j + 1}": f"o{j}" for j in range(6)}), ["(F)"])],
        {0: {"accuracy": 1.0}}),
    "mirb": ("ext", "make_mirb", (), [
        ({"questions": " How many?", "answers": "12", "subset": "count",
          "image_list": [IMG, IMG]}, ["There are 12."]),
        ({"questions": " How many?", "answers": "12", "subset": "count",
          "image_list": [IMG, IMG]}, ["eleven"])],
        {0: {"accuracy": 1.0}, 1: {"accuracy": 0.0}}),
    "conbench": ("ext", "make_conbench", (), [
        (dict(CONBENCH_BASE, question="Is it?", question_field="N/Y",
              answer="Yes"), ["Yes, it is"]),
        (dict(CONBENCH_BASE, question="A or B?", question_field="Choices",
              answer="A"), [" A."]),
        (dict(CONBENCH_BASE, question="What?", question_field="Q/A",
              answer="a red car"), ["a red car"]),
        (dict(CONBENCH_BASE, image_id="8", question="What?",
              question_field="Q/A", answer="a red car"), ["a blue bike"])],
        {0: {"accuracy": 1.0}, 2: {"accuracy": 1.0}, 3: {"accuracy": 0.0}}),
    "tempcompass_yes_no": ("ext", "make_tempcompass", (None, "yes_no"), [
        ({"question": "q", "answer": "yes", "dim": "direction",
          "video": VID}, ["Yes."])],
        {0: {"avg_accuracy": 1.0}}),
    "tempcompass_caption_matching": (
        "ext", "make_tempcompass", (None, "caption_matching"), [
            ({"question": TEMPCOMPASS_Q, "answer": "Caption A: a dog runs "
              "left", "dim": "order", "video": VID}, [p])
            for p in ("Caption A", "A.", "B) a dog runs left", "Caption B",
                      "something else")],
        {0: {"avg_accuracy": 1.0}, 2: {"avg_accuracy": 1.0},
         3: {"avg_accuracy": 0.0}}),
    "tempcompass_mc": ("ext", "make_tempcompass", (None, "multi-choice"), [
        ({"question": "q", "answer": "B. a cat", "dim": "order",
          "video": VID}, [p]) for p in ("B", "B)", "C", "it is a cat")],
        {0: {"avg_accuracy": 1.0}, 1: {"avg_accuracy": 1.0},
         2: {"avg_accuracy": 0.0}, 3: {"avg_accuracy": 0.0}}),
    "mmbench_en_dev": ("mmbench", "make_mmbench", ("mmbench_en_dev",), [
        (d, [r]) for d, r in zip(JMB.make_mmbench("x").synthetic_docs(4),
                                 ["A", "Z", "the green one", "(C)"])],
        {}),
    "mmbench_cn_cc": ("mmbench", "make_mmbench", (
        "mmbench_cn_cc", None, "cc", "有如下几个选项：",
        "\n请直接使用所提供的选项字母作为答案回答。"), [
        (d, [d["answer"]]) for d in JMB.make_mmbench("x").synthetic_docs(4)],
        {0: {"_hit": 1.0}}),
    "mmaad_base": ("mmupd", "make_mmupd", ("aad", "base"), [
        (d, [d["answer"] if d["type"] == "standard" else
             "None of the above"])
        for d in JMU.make_mmupd("aad", "base").synthetic_docs(4)],
        {0: {"_row_ok": 1.0}, 1: {"_row_ok": 1.0}}),
    "mmivqd_instruction": ("mmupd", "make_mmupd", ("ivqd", "inst"), [
        (d, ["A"]) for d in JMU.make_mmupd("aad", "base").synthetic_docs(4)]
        + [({"type": "upd", "A": "red", "B": "green", "answer": "F",
             "question": "q", "image": IMG}, ["F. None of the above"])],
        {4: {"_row_ok": 1.0}}),
    "llava_in_the_wild": ("judge", "make_llava_bench",
                          ("llava_in_the_wild",), [
        (d, [r]) for d, r in zip(
            JTJ.make_llava_bench().synthetic_docs(3),
            ["A colorful test pattern number 0 with random pixels.",
             "zebra", ""])],
        {0: {"_pair_all": (10.0, 10.0)}}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_task_matches_jax_on_the_jax_tests_docs(case):
    """The JAX tests' docs and responses: the port's contexts, visuals,
    requests' choices, rows and aggregate equal JAX's, and its rows take
    the values those tests assert."""
    mod, maker, args, pairs, expect = CASES[case]
    tmod, jmod = MODULES[mod]
    mine, theirs = getattr(tmod, maker)(*args), getattr(jmod, maker)(*args)
    for attr in ("name", "split", "gen_kwargs", "metric_names",
                 "output_type"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    rows, jrows = [], []
    for d, resps in pairs:
        assert mine.doc_to_text(d) == theirs.doc_to_text(d)
        _same(mine.doc_to_visual(d), theirs.doc_to_visual(d))
        if mine.doc_to_choice is not None:
            assert mine.doc_to_choice(d) == theirs.doc_to_choice(d)
        rows.append(mine.process_results(d, resps))
        jrows.append(theirs.process_results(d, resps))
    _same(rows, jrows)
    _same(mine.aggregate(rows), theirs.aggregate(jrows))
    for i, kv in expect.items():
        for k, v in kv.items():
            assert rows[i][k] == v, (i, k)


def test_mmbench_and_mmupd_grouped_scores_match_jax():
    """The circular mmbench groups (a question hits only when every
    rotation does) and mmupd's dual accuracy, as tests/test_tasks_round4.py
    and tests/test_tasks_round4b.py check them, in both packages."""
    for mb in (TMB, JMB):
        t = mb.make_mmbench("mmbench_en_dev")
        by_idx = {d["index"]: d for d in t.synthetic_docs(4)}
        d0, d1 = by_idx[0], by_idx[1000000]
        hit = [t.process_results(d0, [d0["answer"]]),
               t.process_results(d1, [d1["answer"]])]
        miss = [hit[0], t.process_results(d1, ["Z"])]
        assert t.aggregate_extra(hit)["gpt_eval_score"] == 1.0
        assert t.aggregate_extra(miss)["gpt_eval_score"] == 0.0
        assert "There are several options:" in t.doc_to_text(d0)
    for mu in (TMU, JMU):
        t = mu.make_mmupd("aad", "base")
        docs = t.synthetic_docs(4)
        good = [t.process_results(d, [d["answer"] if d["type"] == "standard"
                                      else "None of the above"])
                for d in docs]
        agg = t.aggregate_extra(good)
        assert (agg["gpt_eval_score"], agg["overall_acc_standard"],
                agg["overall_acc_upd"]) == (100.0, 1.0, 1.0)
        always_a = [t.process_results(d, ["A"]) for d in docs]
        assert t.aggregate_extra(always_a)["gpt_eval_score"] == 0.0


# ---------------------------------------------------------------------------
# the rules on drawn text
# ---------------------------------------------------------------------------

PIECES = ["A", "B", "C", "D", "E", "F", "(A)", "B.", "C)", ":D", "(E).",
          "A,", "red", "green", "blue", "None of the above", "I cannot",
          "image is incompatible", "The answer is", "The best answer is",
          "Best option:", "answer is (J)", "cat", " ", "\n", "a", "1", "12"]
TEXT = st.one_of(st.text(max_size=24),
                 st.lists(st.sampled_from(PIECES), max_size=8).map(" ".join))
CHOICES = st.dictionaries(st.sampled_from("ABCDE"),
                          st.one_of(st.sampled_from(["red", "green", "blue",
                                                     "cat", "a"]),
                                    st.text(max_size=6)), max_size=5)

RULES = {
    "can_infer_option": lambda m, t, c: m.can_infer_option(t),
    "can_infer_option_4": lambda m, t, c: m.can_infer_option(t, 4),
    "can_infer_text": lambda m, t, c: m.can_infer_text(t, c),
    "can_infer": lambda m, t, c: m.can_infer(t, c),
}
EXT_RULES = {
    "extract_letter": lambda m, t, c: m.extract_letter(t),
    "extract_letter_choices": lambda m, t, c: m.extract_letter(
        t, "ABCDE", [f"({k}) {v}" for k, v in sorted(c.items())]),
    "strip_answer_prefixes": lambda m, t, c: m.strip_answer_prefixes(t),
    "websrc_f1": lambda m, t, c: m.websrc_f1(t, " ".join(c.values())),
    "ii_bench_extract": lambda m, t, c: m.ii_bench_extract(t),
    "edit_distance_accuracy": lambda m, t, c: m.edit_distance_accuracy(
        t, "".join(c.values())),
    "tempcompass_mc": lambda m, t, c: m._tempcompass_mc_rating(t,
                                                               "B. a cat"),
    "tempcompass_caption": lambda m, t, c: m._tempcompass_caption_rating(
        t, TEMPCOMPASS_Q, "Caption A: a dog runs left"),
    "gold_letter": lambda m, t, c: (m._gold_letter(t) if t.strip()
                                    and not t.strip().isdigit() else None),
}


@pytest.mark.parametrize("name", sorted(RULES))
@settings(max_examples=80, deadline=None)
@given(text=TEXT, choices=CHOICES)
def test_mmbench_rule_matches_jax_on_drawn_text(name, text, choices):
    assert RULES[name](TMB, text, choices) == RULES[name](JMB, text, choices)


@pytest.mark.parametrize("name", sorted(EXT_RULES))
@settings(max_examples=60, deadline=None)
@given(text=TEXT, choices=CHOICES)
def test_ext_rule_matches_jax_on_drawn_text(name, text, choices):
    assert EXT_RULES[name](TX, text, choices) == \
        EXT_RULES[name](JX, text, choices)


@settings(max_examples=80, deadline=None)
@given(pred=TEXT, ref=TEXT)
def test_token_f1_matches_jax_on_drawn_text(pred, ref):
    assert TTJ._token_f1(pred, ref) == JTJ._token_f1(pred, ref)


@pytest.mark.parametrize("question_type", ["base", "option", "inst"])
@settings(max_examples=60, deadline=None)
@given(pred=TEXT, choices=CHOICES, upd=st.booleans(),
       gold=st.sampled_from("ABCF"))
def test_mmupd_grade_row_matches_jax_on_drawn_text(question_type, pred,
                                                   choices, upd, gold):
    doc = dict(choices, type="upd" if upd else "standard", answer=gold)
    assert TMU.mmupd_grade_row(doc, pred, question_type) == \
        JMU.mmupd_grade_row(doc, pred, question_type)


# ---------------------------------------------------------------------------
# YAML tasks
# ---------------------------------------------------------------------------

HOOKS = '''def to_text(doc, lmms_eval_specific_kwargs):
    kw = lmms_eval_specific_kwargs
    return f"{kw['pre_prompt']}{doc['question']}{kw['post_prompt']}"


def to_visual(doc):
    return []


def question(doc):
    return doc["question"]


def score(doc, results):
    return {"relaxed_overall": float(results[0].strip() == doc["answer"])}
'''

YAMLS = {
    # the lmms-eval tasks/<name>/utils.py convention (the JAX test's form)
    "local_hooks": '''task: "yaml_local"
dataset_path: {docs}
test_split: test
output_type: generate_until
doc_to_visual: !function myutils.to_visual
doc_to_text: !function myutils.to_text
doc_to_target: "answer"
generation_kwargs:
  max_new_tokens: 8
  temperature: 0
  do_sample: False
process_results: !function myutils.score
metric_list:
  - metric: relaxed_overall
    aggregation: mean
lmms_eval_specific_kwargs:
  default:
    pre_prompt: "Q: "
    post_prompt: "\\nAnswer briefly."
''',
    # hooks that name no file beside the YAML: each package's task_utils
    "package_hooks": '''task: "yaml_mathvista"
dataset_path: {docs}
doc_to_text: !function mathvista.doc_to_text
doc_to_visual: !function mathvista.doc_to_visual
process_results: !function mathvista.process_results
metric_list:
  - metric: accuracy
''',
    # no hooks but the prompt: the default exact_match of doc_to_target
    "defaults": '''doc_to_text: !function myutils.question
dataset_path: {docs}
''',
}
DOCS = [{"question": "How many?", "answer": "2", "question_type": "free_form",
         "answer_type": "integer", "precision": 0, "query": "How many?"},
        {"question": "Which color?", "answer": "blue", "choices": ["red",
                                                                  "blue"],
         "question_type": "multi_choice", "answer_type": "text",
         "precision": 0, "query": "Which color?"}]


@pytest.mark.parametrize("form", sorted(YAMLS))
def test_yaml_task_matches_jax(form, tmp_path):
    """load_yaml_task of one file in both packages: the same fields,
    contexts (the YAML's model kwargs passed to the hook), targets and
    scores; package hooks resolve in each package's own task_utils."""
    (tmp_path / "myutils.py").write_text(HOOKS)
    docs = tmp_path / "docs.json"
    docs.write_text(json.dumps(DOCS))
    path = tmp_path / f"{form}.yaml"
    path.write_text(YAMLS[form].format(docs=docs))
    mine, theirs = TY.load_yaml_task(str(path)), JY.load_yaml_task(str(path))
    for attr in ("name", "split", "gen_kwargs", "metric_names",
                 "output_type", "dataset_path"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    d = mine.load_docs()
    _same(d, theirs.load_docs())
    for doc in d:
        assert mine.doc_to_text(doc) == theirs.doc_to_text(doc)
        _same(mine.doc_to_visual(doc), theirs.doc_to_visual(doc))
        for resp in ("2", "blue", "The answer is B.", ""):
            _same(mine.process_results(doc, [resp]),
                  theirs.process_results(doc, [resp]))
    if form == "package_hooks":
        assert mine.process_results.__module__ == \
            "msd_tpu_torch.harness.task_utils.mathvista"
        assert theirs.process_results.__module__ == \
            "msd_tpu.harness.task_utils.mathvista"
    if form == "local_hooks":
        assert mine.doc_to_text(d[0]) == "Q: How many?\nAnswer briefly."
        assert mine.gen_kwargs == {"max_new_tokens": 8, "temperature": 0}


def test_register_yaml_dir_matches_jax(tmp_path):
    """register_yaml_dir over a tree: the same names in the same order,
    '_'-prefixed files skipped, the dataset root joined to a relative
    dataset_path."""
    from msd_tpu.harness import registry as JR
    from msd_tpu_torch.harness import registry as TR

    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "myutils.py").write_text(HOOKS)
    (tmp_path / "myutils.py").write_text(HOOKS)
    for name, rel in (("b.yaml", "sub/b.yaml"), ("a.yml", "a.yml"),
                      ("_skip.yaml", "_skip.yaml")):
        (tmp_path / rel).write_text(YAMLS["defaults"].format(
            docs="data/docs.json"))
    saved = {R: dict(R.TASK_REGISTRY) for R in (TR, JR)}
    try:
        names = TY.register_yaml_dir(str(tmp_path), dataset_root="/r")
        jnames = JY.register_yaml_dir(str(tmp_path), dataset_root="/r")
        assert names == jnames == ["a", "b"]
        for n in names:
            assert TR.TASK_REGISTRY[n].dataset_path == \
                JR.TASK_REGISTRY[n].dataset_path == \
                os.path.join("/r", "data/docs.json")
    finally:
        for R, s in saved.items():
            R.TASK_REGISTRY.clear()
            R.TASK_REGISTRY.update(s)
