"""The port's task modules of the rest of the extended tier
(``tasks_ext2``, ``tasks_ext3``, ``tasks_judge2``, ``tasks_audio``,
``tasks_ext4``, ``tasks_mmsearch``) and its IFEval checkers
(``task_utils/ifeval``) against the JAX package's, on the CPU.

Port-side counterparts of tests/test_tasks_round4.py (its ext2 part),
tests/test_tasks_round4b.py (its ifeval, ext3, judge2, audio and ext4
parts) and tests/test_tasks_mmsearch.py: the same docs and responses
through both packages' makers give the same contexts, visuals, scores and
aggregates (and the values the JAX tests assert); the shared rules (every
IFEval instruction, the loose variants, WER, the vcr, cinepile, interleave,
wildvision, MMSearch and olympiadbench rules, vitatecs' seeded option
order) equal JAX's on text drawn by hypothesis; every judged scorer gives
the same rows and asks the same prompts with an in-process judge
installed, and with none. Every task of the six modules is held against
JAX's on its synthetic docs by tests/test_torch_harness.py.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from msd_tpu.harness import judge as JJ
from msd_tpu.harness import tasks_audio as JA
from msd_tpu.harness import tasks_ext2 as JE2
from msd_tpu.harness import tasks_ext3 as JE3
from msd_tpu.harness import tasks_ext4 as JE4
from msd_tpu.harness import tasks_judge2 as JJ2
from msd_tpu.harness import tasks_mmsearch as JMS
from msd_tpu.harness.instance import Instance as JInstance
from msd_tpu.harness.models.llava_msd import run_multi_round as j_rounds
from msd_tpu.harness.task_utils import ifeval as JIF
from msd_tpu_torch.harness import judge as TJ
from msd_tpu_torch.harness import tasks_audio as TA
from msd_tpu_torch.harness import tasks_ext2 as TE2
from msd_tpu_torch.harness import tasks_ext3 as TE3
from msd_tpu_torch.harness import tasks_ext4 as TE4
from msd_tpu_torch.harness import tasks_judge2 as TJ2
from msd_tpu_torch.harness import tasks_mmsearch as TMS
from msd_tpu_torch.harness.instance import Instance as TInstance
from msd_tpu_torch.harness.models.llava_msd import run_multi_round as t_rounds
from msd_tpu_torch.harness.task_utils import ifeval as TIF

IMG = np.zeros((8, 8, 3), np.uint8)
MODULES = {"ext2": (TE2, JE2), "ext3": (TE3, JE3), "judge2": (TJ2, JJ2),
           "audio": (TA, JA), "ext4": (TE4, JE4), "mmsearch": (TMS, JMS)}


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
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


def synth(mod, maker, args, n):
    """The JAX maker's synthetic docs (the JAX tests' docs)."""
    return getattr(MODULES[mod][1], maker)(*args).synthetic_docs(n)


# ---------------------------------------------------------------------------
# the JAX tests' docs and responses through both packages
# ---------------------------------------------------------------------------

def _other(letter):
    return "B" if letter == "A" else "A"


MMVET2_DOC = {"question": "nums?", "answer": "3 <AND> 4",
              "capability": "ocr, math", "image": IMG}
VITATECS_DOC = {"caption": "a person opens door 1",
                "counterfactual": "a person closes door 1"}
VITATECS_GOLD = JE3._vitatecs_qa(VITATECS_DOC)[1][1]
IFEVAL_DOC = {"prompt": "p", "instruction_id_list": ["startend:quotation"],
              "kwargs": [{}]}
MIX_MC = synth("judge2", "make_mix_evals_video2text", ("mc",), 3)[2]
MIX_FREE = synth("judge2", "make_mix_evals_video2text", ("freeform",), 2)[1]
RERANK = synth("mmsearch", "make_mmsearch_rerank", (), 8)[3]
VINO = synth("ext4", "make_vinoground", (), 8)
TBENCH = synth("ext3", "make_temporalbench", ("short_qa",), 4)
OLY = synth("ext3", "make_olympiadbench", (), 3)[1]
SUMM = synth("mmsearch", "make_mmsearch_summarization", (), 3)[1]
E2E = synth("mmsearch", "make_mmsearch_end2end", (), 2)
CMMMU = synth("ext2", "make_cmmmu", (), 6)

# case: (module, maker, maker args, [(doc, response list)], the values the
# JAX tests assert of the port's rows: {row index: {key: value}}, and of
# its aggregate: {key: value})
CASES = {
    "seedbench_2_plus": ("ext2", "make_seedbench_2_plus", (), [
        (d, [d["answer"]]) for d in synth("ext2", "make_seedbench_2_plus",
                                          (), 6)]
        + [(synth("ext2", "make_seedbench_2_plus", (), 3)[1],
            ["B. option 1"])],
        {0: {"accuracy": 1.0}}, {}),
    "mmmu_pro_standard": ("ext2", "make_mmmu_pro", ("standard",), [
        (synth("ext2", "make_mmmu_pro", ("standard",), 12)[9], [r])
        for r in ("J", "A")],
        {0: {"accuracy": 1.0}, 1: {"accuracy": 0.0}}, {}),
    "mmmu_pro_vision": ("ext2", "make_mmmu_pro", ("vision",), [
        (d, [d["answer"]]) for d in synth("ext2", "make_mmmu_pro",
                                          ("vision",), 3)], {}, {}),
    "cmmmu_val": ("ext2", "make_cmmmu", (), [
        (CMMMU[0], [CMMMU[0]["answer"]]), (CMMMU[1], [CMMMU[1]["answer"]]),
        (CMMMU[1], ["错" if CMMMU[1]["answer"] == "对" else "对"]),
        (CMMMU[2], [f"答案是{CMMMU[2]['answer']}。"])],
        {0: {"accuracy": 1.0}, 1: {"accuracy": 1.0}, 2: {"accuracy": 0.0},
         3: {"accuracy": 1.0}}, {}),
    "cinepile": ("ext2", "make_cinepile", (), [
        (d, ["ABCDE"[d["answer_key_position"]]])
        for d in synth("ext2", "make_cinepile", (), 3)],
        {2: {"accuracy": 1.0}}, {}),
    "vcr_wiki_en_easy": ("ext2", "make_vcr", ("en", "easy"), [
        (d, [d["caption"]]) for d in synth("ext2", "make_vcr",
                                           ("en", "easy"), 2)],
        {0: {"exact_match": 1.0}}, {}),
    "vcr_wiki_zh_hard": ("ext2", "make_vcr", ("zh", "hard"), [
        (d, [r]) for d in synth("ext2", "make_vcr", ("zh", "hard"), 2)
        for r in (d["caption"], "Sorry, I cannot see it")], {}, {}),
    "mmvetv2": ("ext2", "make_mmvetv2", (), [
        (MMVET2_DOC, ["3 and 4"]), (MMVET2_DOC, ["3"])],
        {0: {"gpt_eval_score": 1.0}, 1: {"gpt_eval_score": 0.5}}, {}),
    "activitynetqa": ("ext2", "make_activitynetqa", (), [
        (d, [r]) for d in synth("ext2", "make_activitynetqa", (), 4)
        for r in (d["answer"], "completely unrelated")],
        {0: {"accuracy": 1.0, "score": 5.0}, 1: {"accuracy": 0.0}}, {}),
    "videochatgpt_gen": ("ext2", "make_videochatgpt_gen", (), [
        (d, [r]) for d in synth("ext2", "make_videochatgpt_gen", (), 2)
        for r in (d["answer"], "no")], {}, {}),
    "llava_wilder_small": ("ext2", "make_llava_wilder", (), [
        (d, [r]) for d in synth("ext2", "make_llava_wilder", (), 2)
        for r in ("a test pattern", "")], {}, {}),
    "temporalbench_short_qa": ("ext3", "make_temporalbench", ("short_qa",),
                               [(d, [d["GT"]]) for d in TBENCH]
                               + [(TBENCH[0], [_other(TBENCH[0]["GT"])]),
                                  (TBENCH[1], ["B. no, it did not"])],
                               {0: {"accuracy": 1.0}, 4: {"accuracy": 0.0}},
                               {}),
    "vitatecs_direction": ("ext3", "make_vitatecs", ("Direction",), [
        (VITATECS_DOC, [r]) for r in (
            VITATECS_GOLD, _other(VITATECS_GOLD), VITATECS_DOC["caption"],
            VITATECS_DOC["counterfactual"], "no idea")],
        {0: {"accuracy": 1.0}, 1: {"accuracy": 0.0}, 2: {"accuracy": 1.0},
         3: {"accuracy": 0.0}, 4: {"accuracy": 0.0}}, {}),
    "jmmmu": ("ext3", "make_jmmmu", (), [
        (d, [d["answer"]]) for d in synth("ext3", "make_jmmmu", (), 4)]
        + [(synth("ext3", "make_jmmmu", (), 1)[0], ["Z no letter here"])],
        {2: {"accuracy": 1.0, "_sub_Physics": 1.0}}, {}),
    "mmworld": ("ext3", "make_mmworld", (), [
        (d, [d["correct_answer_label"].upper()])
        for d in synth("ext3", "make_mmworld", (), 6)] + [
        (synth("ext3", "make_mmworld", (), 1)[0],
         ["The best answer is "
          + synth("ext3", "make_mmworld", (), 1)[0][
              "correct_answer_label"].upper()]),
        (synth("ext3", "make_mmworld", (), 1)[0],
         ["this is a very long answer with many words and no option letter "
          "at all"])],
        {6: {"accuracy": 1.0}, 7: {"accuracy": 0.0}}, {}),
    "youcook2_val": ("ext3", "make_youcook2", (), [
        (d, [d["sentence"]]) for d in synth("ext3", "make_youcook2", (), 4)]
        + [(synth("ext3", "make_youcook2", (), 1)[0], ["café cooking"])],
        {}, {}),
    "video_detail_description": (
        "ext3", "make_video_detail_description", (), [
            (synth("ext3", "make_video_detail_description", (), 2)[0], [r])
            for r in (synth("ext3", "make_video_detail_description", (),
                            1)[0]["answer"], "nothing relevant")],
        {0: {"gpt_eval_score": 5.0}}, {}),
    "olympiadbench_test_en": ("ext3", "make_olympiadbench", (), [
        (OLY, ["Working... So the final answer is \\boxed{3}."]),
        (OLY, ["So the final answer is \\boxed{4}."]),
        (dict(OLY, source="TP_synth"), ["anything"])],
        {0: {"exact_match": 1.0}, 1: {"exact_match": 0.0}}, {}),
    "ifeval": ("ext3", "make_ifeval", (), [
        (IFEVAL_DOC, ['Sure! Here you go:\n"quoted answer"'])] + [
        (d, [r]) for d in synth("ext3", "make_ifeval", (), 2)
        for r in ("no commas in this reply at all", "one, two")],
        {0: {"prompt_level_strict_acc": 0.0, "prompt_level_loose_acc": 1.0}},
        {}),
    "wildvision_0617": ("judge2", "make_wild_vision", (), [
        (d, [r]) for d in synth("judge2", "make_wild_vision", (), 2)[:1]
        for r in (d["claude-3-sonnet-20240229"], "nothing relevant at all")],
        {0: {"raw_score": 0.0}, 1: {"raw_score": -1.0}}, {}),
    "vibe_eval": ("judge2", "make_vibe_eval", (), [
        (synth("judge2", "make_vibe_eval", (), 2)[1], [r])
        for r in (synth("judge2", "make_vibe_eval", (), 2)[1]["reference"],
                  "zzz")],
        {0: {"score100": 100.0, "_hard": 100.0}}, {}),
    "mia_bench": ("judge2", "make_mia_bench", (), [
        (d, [d["instruction"]]) for d in synth("judge2", "make_mia_bench",
                                               (), 1)],
        {0: {"total_score": 1.0}}, {}),
    "cvrr": ("judge2", "make_cvrr", (), [
        (synth("judge2", "make_cvrr", (), 2)[0], [r])
        for r in (synth("judge2", "make_cvrr", (), 1)[0]["answer"],
                  "unrelated")],
        {0: {"accuracy": 1.0, "score": 5.0}, 1: {"accuracy": 0.0}}, {}),
    "moviechat_global": ("judge2", "make_moviechat", ("global",), [
        (d, [d["answer"]]) for d in synth("judge2", "make_moviechat",
                                          ("global",), 1)],
        {0: {"accuracy": 1.0}}, {}),
    "moviechat_breakpoint": ("judge2", "make_moviechat", ("breakpoint",), [
        (d, [r]) for d in synth("judge2", "make_moviechat",
                                ("breakpoint",), 2)
        for r in (d["answer"], "no")], {}, {}),
    "cuva": ("judge2", "make_cuva", (), [
        (d, [d["answer"]]) for d in synth("judge2", "make_cuva", (), 3)],
        {}, {}),
    "llava_interleave_bench": ("judge2", "make_llava_interleave", (), [
        (d, [d["answer"]]) for d in synth("judge2", "make_llava_interleave",
                                          (), 4)],
        {}, {"category_mean": 1.0}),
    "mix_evals_video2text_mc": ("judge2", "make_mix_evals_video2text",
                                ("mc",), [
        (MIX_MC, [MIX_MC["answer"]]), (MIX_MC, ["no letter here at all"]),
        (dict(MIX_MC, answer=MIX_MC["options"][ord(MIX_MC["answer"])
                                               - ord("A")]),
         [MIX_MC["answer"]])],
        {0: {"exact_match": 1.0}, 1: {"exact_match": 0.0},
         2: {"exact_match": 1.0}}, {}),
    "mix_evals_video2text_freeform": ("judge2", "make_mix_evals_video2text",
                                      ("freeform",), [
        (MIX_FREE, [MIX_FREE["reference_answer"][0]]), (MIX_FREE, ["zzz"])],
        {0: {"gpt_eval": 1.0}}, {}),
    "librispeech_test_clean": ("audio", "make_asr_task",
                               ("librispeech_test_clean",), [
        (d, [r]) for d in synth("audio", "make_asr_task",
                                ("librispeech_test_clean",), 2)
        for r in (d["gt"], "something else entirely")],
        {0: {"wer": 0.0}}, {}),
    "common_voice_15_en": ("audio", "make_asr_task",
                           ("common_voice_15_en",), [
        (d, [d["gt"].upper() + "!"]) for d in synth(
            "audio", "make_asr_task", ("common_voice_15_en",), 2)],
        {0: {"wer": 0.0}}, {}),
    "vocalsound_test": ("audio", "make_vocalsound", (), [
        (d, [d["answer"]]) for d in synth("audio", "make_vocalsound", (), 6)],
        {0: {"accuracy": 1.0}}, {"female": 1.0, "male": 1.0}),
    "muchomusic": ("audio", "make_muchomusic", (), [
        (synth("audio", "make_muchomusic", (), 3)[1],
         [synth("audio", "make_muchomusic", (), 3)[1]["answer"][1]])],
        {0: {"accuracy": 1.0}}, {}),
    "air_bench_foundation": ("audio", "make_air_bench", ("foundation",), [
        (synth("audio", "make_air_bench", ("foundation",), 4)[2], [r])
        for r in ("C", "A")],
        {0: {"accuracy": 1.0}, 1: {"accuracy": 0.0}}, {}),
    "air_bench_chat": ("audio", "make_air_bench", ("chat",), [
        (d, [r]) for d in synth("audio", "make_air_bench", ("chat",), 2)
        for r in ("a dog barks", "")], {}, {}),
    "clotho_aqa_test": ("audio", "make_clotho_aqa", (), [
        (d, [r]) for d in synth("audio", "make_clotho_aqa", (), 2)
        for r in (d["answer"], "no")], {}, {}),
    "av_odyssey": ("ext4", "make_av_odyssey", (), [
        (d, [d["answer"]]) for d in synth("ext4", "make_av_odyssey", (), 8)],
        {i: {"accuracy": 1.0} for i in range(8)},
        {"timbre": 1.0, "tone": 1.0}),
    "vinoground": ("ext4", "make_vinoground", (), [
        (d, [_other(d["GT"]) if i == 1 else d["GT"]])
        for i, d in enumerate(VINO)],
        {}, {"text_score": 0.5, "group_score": 0.5, "video_score": 1.0}),
    "live_bench": ("ext4", "make_live_bench", (), [
        (synth("ext4", "make_live_bench", (), 2)[0], [r])
        for r in ("", synth("ext4", "make_live_bench", (), 1)[0]["answer"])],
        {0: {"gpt4_eval_score": 0.0}, 1: {"gpt4_eval_score": 10.0}}, {}),
    "ferret": ("ext4", "make_ferret", (), [
        (d, [d["gpt_answer"]]) for d in synth("ext4", "make_ferret", (),
                                              3)[:1]],
        {}, {"gpt_eval_ferret_all": 100.0}),
    "vdc_detailed_test": ("ext4", "make_vdc", ("detailed",), [
        (d, [d["caption"]]) for d in synth("ext4", "make_vdc",
                                           ("detailed",), 3)],
        {}, {}),
    "mmsearch_rerank": ("mmsearch", "make_mmsearch_rerank", (), [
        (RERANK, [f"<Website {i + 1}>"]) for i in (
            RERANK["valid"][0], RERANK["not_sure"][0],
            RERANK["invalid"][0])] + [(RERANK, ["Website one"])],
        {0: {"rek_score": 1.0}, 1: {"rek_score": 0.5}, 2: {"rek_score": 0.0},
         3: {"rek_score": 0.0}}, {}),
    "mmsearch_summarization": ("mmsearch", "make_mmsearch_summarization",
                               (), [
        (SUMM, [SUMM["gt_answer"]]), (SUMM, [SUMM["alternative_gt_answers"][
            0]])],
        {0: {"summarization_f1_score": 1.0},
         1: {"summarization_f1_score": 1.0}}, {}),
    "mmsearch_end2end": ("mmsearch", "make_mmsearch_end2end", (), [
        (E2E[0], [[E2E[0]["gt_requery"], "<Website 1>",
                   E2E[0]["gt_answer"]]]),
        (E2E[1], [["totally different words", "<Website 9>",
                   "wrong answer"]])],
        {0: {"end2end_f1_score": 1.0}, 1: {"end2end_f1_score": 0.0}}, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_task_matches_jax_on_the_jax_tests_docs(case):
    """The JAX tests' docs and responses: the port's contexts, visuals,
    choices, rows and aggregate equal JAX's, and its rows and aggregate
    take the values those tests assert."""
    mod, maker, args, pairs, expect, expect_agg = CASES[case]
    tmod, jmod = MODULES[mod]
    mine, theirs = getattr(tmod, maker)(*args), getattr(jmod, maker)(*args)
    for attr in ("name", "split", "gen_kwargs", "metric_names",
                 "output_type"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    rows, jrows = [], []
    for d, resps in pairs:
        if mine.output_type != "generate_until_multi_round":
            assert mine.doc_to_text(d) == theirs.doc_to_text(d)
        _same(mine.doc_to_visual(d), theirs.doc_to_visual(d))
        if mine.doc_to_choice is not None:
            assert mine.doc_to_choice(d) == theirs.doc_to_choice(d)
        rows.append(mine.process_results(d, resps))
        jrows.append(theirs.process_results(d, resps))
    _same(rows, jrows)
    agg = mine.aggregate(rows)
    _same(agg, theirs.aggregate(jrows))
    for i, kv in expect.items():
        for k, v in kv.items():
            assert rows[i][k] == v, (i, k)
    for k, v in expect_agg.items():
        assert agg[k] == v, k


def test_the_jax_tests_rules_hold_in_the_port():
    """The spot values of the JAX tests' rule checks, on the port."""
    assert TE2.cinepile_eval("Answer: A) event 0", "A", "event 0") == 1.0
    assert TE2.cinepile_eval("Answer: A) wrong text", "A", "event 0") == 0.0
    s = TE2.vcr_score_single("hidden words", "the hidden words are here",
                             "en")
    assert s["exact_match"] == 1.0 and s["jaccard"] == 1.0
    assert TE2.vcr_score_single("隐藏文本", "图中是隐藏文本内容",
                                "zh")["exact_match"] == 1.0
    assert TE3._math_equal("0.5", "\\frac{1}{2}", 1e-8)
    assert TE3._math_equal("1,2", "2, 1", 0)
    assert TE3._math_equal("$x^2 - 1$", "(x-1)*(x+1)", 0)
    assert not TE3._math_equal("1,2", "1, 3", 0)
    assert TJ2.wild_vision_judgement_to_score("B>>A") == (2, "model_b")
    assert TJ2.wild_vision_judgement_to_score("garbage") == (0, "tie")
    assert TJ2.interleave_mcq_acc("B", "the answer is (B)") == 1.0
    assert TJ2.interleave_mcq_acc("the red cube", "The red cube!") == 1.0
    assert TA.wer("hello there world", "hello world") == 0.5
    assert TA.wer("<|en|> 你好 世界", "你好世界", language="zh") == 0.0
    assert TMS.get_f1_score("The Eiffel Tower!", "eiffel tower") == 1.0
    assert TMS.postprocess_rerank("<Website 3>", 2) == ([2], False)
    assert abs(TMS.get_requery_score("iPhone 16 release date",
                                     "iphone 16 release date?")["rouge_l"]
               - 0.5) < 1e-7
    c = TIF.check
    assert c("detectable_format:title", {}, "<<My Title>>\nbody")
    assert not c("detectable_format:number_bullet_lists", {"num_bullets": 2},
                 "* one\n- two\n- three")
    assert c("length_constraints:nth_paragraph_first_word",
             {"num_paragraphs": 2, "nth_paragraph": 2,
              "first_word": "hello"},
             "intro text\n\nHello, second paragraph.")
    assert c("language:response_language", {"language": "zh"}, "你好世界")


def test_grouped_aggregates_match_jax():
    """The grouped scores the JAX tests check: temporalbench's multiple
    binary accuracy (a video counts only when all its QAs are right),
    vinoground's group score, ifeval's instruction-level accuracies, in
    both packages alike."""
    for m in (TE3, JE3):
        t = m.make_temporalbench("short_qa")
        docs = t.synthetic_docs(4)
        rows = [t.process_results(d, [d["GT"]]) for d in docs]
        assert t.aggregate_extra(rows)["multiple_binary_accuracy"] == 1.0
        rows[0] = t.process_results(docs[0], [_other(docs[0]["GT"])])
        assert t.aggregate_extra(rows)["multiple_binary_accuracy"] == 0.5
        ti = m.make_ifeval()
        r = ti.process_results(IFEVAL_DOC,
                               ['Sure! Here you go:\n"quoted answer"'])
        agg = ti.aggregate_extra([r])
        assert (agg["inst_level_loose_acc"],
                agg["inst_level_strict_acc"]) == (1.0, 0.0)
    for m in (TE4, JE4):
        tv = m.make_vinoground()
        docs = tv.synthetic_docs(8)
        rows = [tv.process_results(d, [d["GT"]]) for d in docs]
        agg = tv.aggregate_extra(rows)
        assert agg["text_score"] == 1.0 and agg["group_score"] == 1.0


def test_end2end_rounds_match_jax():
    """mmsearch_end2end's three rounds through each package's
    run_multi_round with one scripted model: the same contexts and
    visuals per round, the same per-round responses and scores."""
    got = []
    for m, inst, rounds in ((TMS, TInstance, t_rounds),
                            (JMS, JInstance, j_rounds)):
        t = m.make_mmsearch_end2end()
        d = t.synthetic_docs(2)[0]
        hit = sum(ord(c) for c in d["query"]) % 8
        calls = []

        def fake(context, visuals, gen_kwargs, d=d, hit=hit, calls=calls):
            calls.append((context, len(visuals)))
            if "Query to the search engine" in context:
                return d["gt_requery"]
            if "<Website Index>" in context:
                return f"<Website {hit + 1}>"
            return d["gt_answer"]

        req = inst(request_type="generate_until_multi_round", doc=d,
                   arguments=(t.doc_to_text(d), dict(t.gen_kwargs),
                              t.doc_to_visual, t.doc_to_text, 0, t.name,
                              t.split), idx=0, task_name=t.name, doc_id=0)
        rr = rounds(fake, [req])[0]
        res = t.process_results(d, [rr])
        assert len(rr) == 3 and res["end2end_f1_score"] == 1.0
        got.append((calls, rr, res))
    _same(got[0], got[1])


# ---------------------------------------------------------------------------
# the rules on drawn text
# ---------------------------------------------------------------------------

PIECES = ["A", "B", "C", "D", "(A)", "B.", "C)", "Answer: A)", "answer",
          "event 0", "red", "cube", "the", "a", "an", ",", ".", "!", "?",
          "\n", "\n\n", "*", "**", "***", "* ", "- ", "<<T>>", "P.S.",
          "Section", "[x]", '"', "```json", "{\"a\": 1}", "```", "yes",
          "no", "My answer is yes.", "******", "HELLO", "World", "你好",
          "世界", "<|en|>", "1", "12", "0.5", "cat", "dog", "Hello,",
          "<Website 3>", "<Website 9>", "A>>B", "B>A", "A=B", "[[B>A]]"]
TEXT = st.one_of(st.text(max_size=24),
                 st.lists(st.sampled_from(PIECES), max_size=10).map(" ".join),
                 st.lists(st.sampled_from(PIECES), max_size=10).map("".join))
REL = st.sampled_from(["less than", "at least"])
WORD = st.sampled_from(["cat", "dog", "the", "hello", "x", "a"])
# each IFEval instruction with kwargs of its own kind
IFEVAL_KW = {
    "keywords:existence": st.fixed_dictionaries(
        {"keywords": st.lists(WORD, max_size=3)}),
    "keywords:frequency": st.fixed_dictionaries(
        {"keyword": WORD, "frequency": st.integers(0, 3), "relation": REL}),
    "keywords:forbidden_words": st.fixed_dictionaries(
        {"forbidden_words": st.lists(WORD, max_size=3)}),
    "keywords:letter_frequency": st.fixed_dictionaries(
        {"letter": st.sampled_from("aeotx"), "let_frequency":
         st.integers(0, 4), "let_relation": REL}),
    "language:response_language": st.fixed_dictionaries(
        {"language": st.sampled_from(["en", "zh", "ru", "fr", "ja"])}),
    "length_constraints:number_sentences": st.fixed_dictionaries(
        {"num_sentences": st.integers(0, 4), "relation": REL}),
    "length_constraints:number_paragraphs": st.fixed_dictionaries(
        {"num_paragraphs": st.integers(1, 3)}),
    "length_constraints:number_words": st.fixed_dictionaries(
        {"num_words": st.integers(0, 8), "relation": REL}),
    "length_constraints:nth_paragraph_first_word": st.fixed_dictionaries(
        {"num_paragraphs": st.integers(1, 3),
         "nth_paragraph": st.integers(1, 3), "first_word": WORD}),
    "detectable_content:number_placeholders": st.fixed_dictionaries(
        {"num_placeholders": st.integers(0, 2)}),
    "detectable_content:postscript": st.fixed_dictionaries(
        {"postscript_marker": st.sampled_from(["P.S.", "P.P.S"])}),
    "detectable_format:number_bullet_lists": st.fixed_dictionaries(
        {"num_bullets": st.integers(0, 3)}),
    "detectable_format:constrained_response": st.just({}),
    "detectable_format:number_highlighted_sections": st.fixed_dictionaries(
        {"num_highlights": st.integers(0, 2)}),
    "detectable_format:multiple_sections": st.fixed_dictionaries(
        {"section_spliter": st.sampled_from(["Section", "SECTION"]),
         "num_sections": st.integers(0, 2)}),
    "detectable_format:json_format": st.just({}),
    "detectable_format:title": st.just({}),
    "combination:two_responses": st.just({}),
    "combination:repeat_prompt": st.one_of(
        st.just({}), st.fixed_dictionaries({"prompt_to_repeat": WORD})),
    "startend:end_checker": st.fixed_dictionaries(
        {"end_phrase": st.sampled_from(["cat", "Is there anything else?"])}),
    "change_case:capital_word_frequency": st.fixed_dictionaries(
        {"capital_frequency": st.integers(0, 2), "capital_relation": REL}),
    "change_case:english_capital": st.just({}),
    "change_case:english_lowercase": st.just({}),
    "punctuation:no_comma": st.just({}),
    "startend:quotation": st.just({}),
}


def test_every_ifeval_instruction_is_drawn():
    assert set(IFEVAL_KW) == set(TIF.CHECKERS) == set(JIF.CHECKERS)


@pytest.mark.parametrize("iid", sorted(IFEVAL_KW))
@settings(max_examples=40, deadline=None)
@given(data=st.data(), text=TEXT, prompt=WORD)
def test_ifeval_check_matches_jax_on_drawn_text(iid, data, text, prompt):
    kw = data.draw(IFEVAL_KW[iid])
    assert TIF.check(iid, kw, text, prompt) == \
        JIF.check(iid, kw, text, prompt)


# responses of each instruction's kind, each checked under kwargs around
# its counts (drawn text rarely lands on a count's edge)
CORPUS = ["One. Two? Three! four", "a ? b", "Why? Because.", "no commas here",
          "one, comma", "<<My Title>>\nbody", "<< >>", '"wrapped fully"',
          "Alpha meets BETA.", "cat and cat", "a doghouse is fine",
          "a dog is not", "first\n***\nsecond", "* one\n- two",
          "* one\n- two\n- three", '```json\n{"a": 1}\n```', '{"a": [1,',
          "yes\n******\nno", "same\n******\nsame", "ALL CAPS HERE",
          "all lower here", "你好世界", "hello world",
          "Привет мир",
          "intro text\n\nHello, second paragraph.", "P.S. later",
          "text\nP.P.S more", "*one* and *two*", "Section 1\nSection 2",
          "[name] lives at [address]", "My answer is maybe.",
          "Is there anything else?", "BIG and BIG and small", "", "   "]
COUNTS = ({}, {"relation": "less than"}, {"relation": "at least"})


@pytest.mark.parametrize("iid", sorted(IFEVAL_KW))
def test_ifeval_check_matches_jax_on_a_corpus(iid):
    keys = ("num_sentences", "num_paragraphs", "num_words", "num_bullets",
            "num_placeholders", "num_highlights", "num_sections",
            "frequency", "let_frequency", "capital_frequency",
            "nth_paragraph")
    for text in CORPUS:
        for n in range(0, 5):
            for extra in COUNTS:
                kw = dict(extra, **{k: n for k in keys},
                          let_relation=extra.get("relation"),
                          capital_relation=extra.get("relation"),
                          keyword="cat", letter="a", language="zh",
                          keywords=["alpha", "beta"], first_word="hello",
                          forbidden_words=["dog"], end_phrase="else?")
                assert TIF.check(iid, kw, text, "p") == \
                    JIF.check(iid, kw, text, "p"), (text, kw)


@settings(max_examples=60, deadline=None)
@given(text=TEXT, ids=st.lists(st.sampled_from(sorted(IFEVAL_KW)),
                               min_size=1, max_size=3))
def test_ifeval_loose_variants_and_evaluate_match_jax(text, ids):
    assert TIF.loose_variants(text) == JIF.loose_variants(text)
    kws = [{} for _ in ids]
    assert TIF.evaluate(ids, kws, text, prompt="p") == \
        JIF.evaluate(ids, kws, text, prompt="p")


RULES = {
    "wer_en": lambda m, a, b: m[3].wer(a, b),
    "wer_zh": lambda m, a, b: m[3].wer(a, b, language="zh"),
    "asr_normalize_en": lambda m, a, b: m[3].asr_normalize(a),
    "asr_normalize_zh": lambda m, a, b: m[3].asr_normalize(a, "zh"),
    "vcr_score_single_en": lambda m, a, b: m[0].vcr_score_single(a, b, "en"),
    "vcr_score_single_zh": lambda m, a, b: m[0].vcr_score_single(a, b, "zh"),
    "cinepile_eval": lambda m, a, b: m[0].cinepile_eval(a, "A", b),
    "interleave_mcq_acc": lambda m, a, b: m[2].interleave_mcq_acc(a, b),
    "wild_vision_judgement_to_score":
        lambda m, a, b: m[2].wild_vision_judgement_to_score(a),
    "get_f1_score": lambda m, a, b: m[5].get_f1_score(a, b),
    "rouge_l_raw": lambda m, a, b: m[5].rouge_l_raw(a, b),
    "bleu1_smoothed": lambda m, a, b: m[5]._bleu1_smoothed(a, b),
    "postprocess_rerank": lambda m, a, b: [m[5].postprocess_rerank(a, n)
                                           for n in (1, 2, 3)],
    "vitatecs_qa": lambda m, a, b: m[1]._vitatecs_qa(
        {"caption": a, "counterfactual": b}),
}
# (ext2, ext3, judge2, audio, ext4, mmsearch) of each package
PORT = tuple(MODULES[k][0] for k in MODULES)
JAX = tuple(MODULES[k][1] for k in MODULES)


@pytest.mark.parametrize("name", sorted(RULES))
@settings(max_examples=60, deadline=None)
@given(a=TEXT, b=TEXT)
def test_rule_matches_jax_on_drawn_text(name, a, b):
    _same(RULES[name](PORT, a, b), RULES[name](JAX, a, b))


# olympiadbench's answers: whole expressions (sympy parses them; drawn
# operators could ask it for huge powers)
EXPRS = ["0.5", "\\frac{1}{2}", "1/2", "2", "2.0000000001", "3", "-3",
         "1,2", "2, 1", "1, 3", "$x^2 - 1$", "(x-1)*(x+1)", "x+1", "1+x",
         "\\sqrt{4}", "\\pi", "3.14159", "\\infty", "a", "", "1e3", "1000",
         "\\boxed{3}", "10\\%", "0.1"]


@settings(max_examples=60, deadline=None)
@given(pred=st.sampled_from(EXPRS), gold=st.sampled_from(EXPRS),
       precision=st.sampled_from([0, 1e-8, 1e-2]))
def test_math_equal_matches_jax(pred, gold, precision):
    assert TE3._math_equal(pred, gold, precision) == \
        JE3._math_equal(pred, gold, precision)


# ---------------------------------------------------------------------------
# the judged scorers with an in-process judge and with none
# ---------------------------------------------------------------------------

# a reply each scorer's parse reads: the smoke stub's by marker, else one
# reply that holds every other scorer's format
FALLBACK = ("Rating: 4\n{'pred': 'yes', 'score': 4}\n\"Rating\": 7\n"
            "total score: 8/10\n[[1]]\nCorrect")


class Judge:
    def __init__(self):
        self.calls = []

    def complete(self, prompt, max_tokens=256, temperature=0.0,
                 system=None):
        self.calls.append((system, prompt, max_tokens, temperature))
        r = chip_smoke.judge_reply(prompt)
        return FALLBACK if r == "ok" else r


JUDGED = {
    "mmvetv2": ("ext2", "make_mmvetv2", (), ["3 and 4", "nothing", "3"]),
    "llava_wilder_small": ("ext2", "make_llava_wilder", (),
                           ["a test pattern", "zebra"]),
    "activitynetqa": ("ext2", "make_activitynetqa", (),
                      ["yes", "completely unrelated", "no"]),
    "videochatgpt_gen": ("ext2", "make_videochatgpt_gen", (),
                         ["a person", "nothing"]),
    "vitatecs_direction": ("ext3", "make_vitatecs", ("Direction",),
                           ["no idea", "A", "the other one"]),
    "video_detail_description": ("ext3", "make_video_detail_description",
                                 (), ["nothing relevant", "a video"]),
    "wildvision_0617": ("judge2", "make_wild_vision", (),
                        ["object 0 is a red cube", "zzz"]),
    "vibe_eval": ("judge2", "make_vibe_eval", (), ["zzz", "a reference"]),
    "mia_bench": ("judge2", "make_mia_bench", (), ["do it", ""]),
    "cvrr": ("judge2", "make_cvrr", (), ["unrelated", "yes"]),
    "moviechat_global": ("judge2", "make_moviechat", ("global",),
                         ["nothing", "a"]),
    "mix_evals_video2text_freeform": ("judge2", "make_mix_evals_video2text",
                                      ("freeform",), ["zzz", "an answer"]),
    "clotho_aqa_test": ("audio", "make_clotho_aqa", (), ["yes", "rain"]),
    "air_bench_chat": ("audio", "make_air_bench", ("chat",),
                       ["a dog barks", "music"]),
    "alpaca_audio_test": ("audio", "make_alpaca_audio", (),
                          ["a reply", "zzz"]),
    "openhermes": ("ext4", "make_openhermes", (), ["an answer", "zzz"]),
    "funqa": ("ext4", "make_funqa", (), ["a cat jumps", "nothing"]),
    "live_bench": ("ext4", "make_live_bench", (), ["event 0 occurred", ""]),
    "ferret": ("ext4", "make_ferret", (), ["a thing", "zzz"]),
    "vdc_camera_test": ("ext4", "make_vdc", ("camera",), ["a pan", "zzz"]),
}


@pytest.fixture(autouse=True)
def _no_judges():
    yield
    TJ.set_judge(None)
    JJ.set_judge(None)


@pytest.mark.parametrize("task", sorted(JUDGED))
def test_judged_scores_match_jax(task):
    """The task's rows and aggregate with an in-process judge installed in
    both packages are equal, with the same prompts asked; with no judge
    both give the offline rule's rows."""
    mod, maker, args, resps = JUDGED[task]
    by = []
    for judged in (True, False):
        got = []
        for J, m in ((TJ, MODULES[mod][0]), (JJ, MODULES[mod][1])):
            judge = Judge() if judged else None
            J.set_judge(judge)
            t = getattr(m, maker)(*args)
            docs = t.synthetic_docs(len(resps))
            rows = [t.process_results(d, [r]) for d, r in zip(docs, resps)]
            got.append((rows, t.aggregate(rows),
                        judge.calls if judge else []))
            J.set_judge(None)
        _same(got[0], got[1])
        by.append(got[0])
    assert by[1][2] == []


@pytest.mark.parametrize("task", ["wildvision_0617", "live_bench",
                                  "mmvetv2"])
def test_smoke_stub_replies_differ_from_the_offline_rule(task):
    """The judged tasks of the smoke's [harness_ext]: the stub's replies
    give scores the offline rule does not, so a dead judge shows."""
    mod, maker, args, resps = JUDGED[task]
    t = getattr(MODULES[mod][0], maker)(*args)
    docs = t.synthetic_docs(len(resps))
    rows = {}
    for judged in (True, False):
        TJ.set_judge(Judge() if judged else None)
        rows[judged] = [t.process_results(d, [r])
                        for d, r in zip(docs, resps) if r]
    assert rows[True] != rows[False]
