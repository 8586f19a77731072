"""The port's judge (``msd_tpu_torch.harness.judge``) and its judged
scorers against the JAX package's, on the CPU.

Port-side counterpart of tests/test_judge.py. One loopback stub judge
(``chip_smoke.judge_stub``: an ``http.server`` thread on 127.0.0.1 with
fixed replies) serves the JAX package's judge and the port's at once:
the offline helpers, ``EndpointJudge`` against the stub (the same request
bodies, the same parse of each reply form), an unreachable endpoint, the
``set_judge`` specs, and the mmvet, mathvista, ``llava_in_the_wild`` and
``mmbench_en_dev`` scorers through the judge give equal values in both
packages. No test connects to anything but 127.0.0.1.
"""

import json

import pytest

import chip_smoke
from msd_tpu.harness import judge as JJ
from msd_tpu.harness import tasks as JT
from msd_tpu.harness import tasks_judge as JTJ
from msd_tpu.harness import tasks_mmbench as JMB
from msd_tpu.harness.task_utils import mathvista as JMV
from msd_tpu_torch.harness import judge as TJ
from msd_tpu_torch.harness import tasks as TT
from msd_tpu_torch.harness import tasks_judge as TTJ
from msd_tpu_torch.harness import tasks_mmbench as TMB
from msd_tpu_torch.harness.task_utils import mathvista as TMV

# (port, JAX): the judge, tasks.py, tasks_judge, tasks_mmbench, mathvista
PKGS = ((TJ, TT, TTJ, TMB, TMV), (JJ, JT, JTJ, JMB, JMV))
# a raw reply body the stub sends instead of its fixed replies, when set
RAW = []


def _reply(prompt):
    return RAW[0] if RAW else chip_smoke.judge_reply(prompt)


@pytest.fixture(autouse=True)
def _clean_judges():
    yield
    RAW.clear()
    TJ.set_judge(None)
    JJ.set_judge(None)


@pytest.fixture(scope="module")
def stub():
    with chip_smoke.judge_stub(_reply) as (url, calls):
        yield url, calls


HELPERS = {
    "mmvet": lambda J: J.mmvet_judge_score("What is x?", "-1 <AND> -5",
                                           "x=-1"),
    "llava_pairwise": lambda J: J.llava_pairwise_scores("ctx", "q", "a1",
                                                        "a2"),
    "videoqa": lambda J: J.videoqa_judge_score("q", "a", "p"),
    "mathvista": lambda J: J.mathvista_judge_extract("Question: pick",
                                                     "It is (B)"),
}
WANT = {"mmvet": 0.5, "llava_pairwise": (8.0, 6.0), "videoqa": ("yes", 4.0),
        "mathvista": "B"}


def _both(fn, judge):
    """fn(port judge module), fn(JAX judge module), each with ``judge``
    installed."""
    out = []
    for J in (TJ, JJ):
        J.set_judge(judge)
        out.append(fn(J))
    return out


@pytest.mark.parametrize("helper", sorted(HELPERS))
def test_offline_helper_matches_jax(helper):
    assert _both(HELPERS[helper], None) == [None, None]


@pytest.mark.parametrize("helper", sorted(HELPERS))
def test_endpoint_judge_matches_jax_against_stub(helper, stub):
    """Each helper through the stub: the same value in both packages (the
    JAX tests' values) and the same request body sent."""
    url, calls = stub
    n0 = len(calls)
    mine, theirs = _both(HELPERS[helper], f"endpoint:{url}")
    assert mine == theirs == WANT[helper]
    sent = calls[n0:]
    assert len(sent) == 2 and sent[0] == sent[1]


REPLIES = {
    "chat": json.dumps({"choices": [{"message": {"content": " 0.7 "}}]}),
    "completions": json.dumps({"choices": [{"text": "0.2"}]}),
    "plain_text": json.dumps({"text": "1.0"}),
    "plain_completion": json.dumps({"completion": "0"}),
    "out_of_range": json.dumps({"choices": [{"message": {"content": "1.7"}}]}),
    "no_number": json.dumps({"choices": [{"message": {"content": "great"}}]}),
    "blank": json.dumps({"choices": [{"message": {"content": "  "}}]}),
    "no_choices": json.dumps({"choices": []}),
    "a_list": json.dumps([1, 2]),
    "not_json": "this is not json",
}


@pytest.mark.parametrize("form", sorted(REPLIES))
def test_endpoint_judge_parses_replies_as_jax(form, stub):
    """EndpointJudge.complete and the mmvet score on each reply form: the
    same result and the same number of requests (a failed parse is
    retried) in both packages."""
    url, calls = stub
    RAW.append(REPLIES[form].encode())
    got = []
    for J in (TJ, JJ):
        J.set_judge(f"endpoint:{url}")
        n0 = len(calls)
        got.append((J.get_judge().complete("hello"),
                    J.mmvet_judge_score("q", "a", "b"), len(calls) - n0))
    assert got[0] == got[1]


def test_unreachable_endpoint_matches_jax():
    """A dead loopback port: no helper raises, each returns None in both
    packages, so every scorer takes its offline rule."""
    dead = f"endpoint:{chip_smoke.dead_judge_url()}"
    for helper in HELPERS.values():
        assert _both(helper, dead) == [None, None]


class _Fixed:
    def complete(self, prompt, **kw):
        return "0.9"


@pytest.mark.parametrize("spec", [None, "", "offline", "endpoint:URL",
                                  "garbage-spec", "object"])
def test_set_judge_specs_match_jax(spec, stub):
    """Each spec installs the same kind of judge (with the same URL) or
    raises ValueError, in both packages."""
    url, _ = stub
    spec = {"endpoint:URL": f"endpoint:{url}",
            "object": _Fixed()}.get(spec, spec)
    got = []
    for J in (TJ, JJ):
        try:
            J.set_judge(spec)
        except ValueError as e:
            got.append(("ValueError", str(e)))
            continue
        j = J.get_judge()
        got.append((type(j).__name__, getattr(j, "url", None),
                    getattr(j, "timeout", None), getattr(j, "retries", None),
                    J.mmvet_judge_score("q", "a", "b")))
    assert got[0] == got[1]


# the judged tasks of tests/test_judge.py and chip_smoke's [harness_ext]:
# (maker, docs, responses), responses chosen so the offline rules settle
# some and not others
def _mmvet(p):
    return p[1].make_mmvet()


def _mathvista(p):
    return p[1].make_mathvista()


def _llava(p):
    return p[2].make_llava_bench("llava_in_the_wild")


def _mmbench(p):
    return p[3].make_mmbench("mmbench_en_dev")


JUDGED = {
    "mmvet": (_mmvet, ["x = -1", "nothing right", "-1 and -5"]),
    "mathvista": (_mathvista, ["hmm, considering everything, the second "
                               "one", "The answer is 3.", ""]),
    "llava_in_the_wild": (_llava, ["A colorful test pattern number 0 with "
                                   "random pixels.", "zebra", ""]),
    "mmbench_en_dev": (_mmbench, ["A", "hmm, the second one", "the green "
                                  "one", "no idea"]),
}


@pytest.mark.parametrize("task", sorted(JUDGED))
def test_judged_scores_match_jax(task, stub):
    """The task's rows and aggregate with the stub judge installed in both
    packages are equal; with an unreachable endpoint both give the offline
    rule's rows (no judge); the judged and offline rows differ."""
    url, _ = stub
    make, resps = JUDGED[task]
    dead = f"endpoint:{chip_smoke.dead_judge_url()}"
    by = {}
    for judge in (f"endpoint:{url}", dead, None):
        got = []
        for p in PKGS:
            p[0].set_judge(judge)
            t = make(p)
            docs = t.load_docs(limit=len(resps))
            rows = [t.process_results(d, [r]) for d, r in zip(docs, resps)]
            got.append((rows, t.aggregate(rows)))
        assert got[0] == got[1]
        by[judge] = got[0]
    assert by[dead] == by[None]
    assert by[f"endpoint:{url}"] != by[None]


def test_mathvista_extraction_asks_the_judge_as_jax(stub):
    """A response no offline rule settles: both packages extract the
    stub's 'B', which normalizes to the second choice."""
    url, _ = stub
    problem = {"question_type": "multi_choice", "answer_type": "text",
               "choices": ["red", "blue"], "query": "Question: color?",
               "answer": "blue", "precision": 0}
    weird = "hmm, considering everything, the second one"
    got = []
    for J, MV in ((TJ, TMV), (JJ, JMV)):
        J.set_judge(f"endpoint:{url}")
        ext = MV.extract_answer(weird, problem)
        got.append((ext, MV.normalize_extracted_answer(
            ext, problem["choices"], "multi_choice", "text", 0)))
    assert got[0] == got[1] == ("B", "blue")
