"""The port's Qwen2-VL harness adapter (``harness/models/qwen2_vl_msd.py``,
registered ``qwen2_vl_msd``) against the JAX package's, on the CPU.

Both adapters run over one set of tiny fp32 weights carried across (a
GQA 4/2 decoder with q/k/v biases, an EAGLE draft, a tiny Qwen2-VL tower on
a 4 x 4 patch grid): ``evaluate`` on ``synthetic_vqa``, ``pope`` and
``ai2d_ppl`` gives JAX's responses, loglikelihoods (1e-4 relative, equal
greedy flags) and ``msd_stats``, built from the constructors and through
``from_pretrained`` of a checkpoint both packages read. Both adapters'
images go through their packages' default (native C++) prep. The CLI runs
the port's random tiny stack (``--model qwen2_vl_msd --model_args
tiny=true --device cpu``).
"""

import numpy as np
import pytest
import torch

import jax

from msd_tpu import configs as JC
from msd_tpu.engine.generator import MSDGenerator as JGen
from msd_tpu.harness import evaluator as JEv
from msd_tpu.harness import registry as JR
from msd_tpu.harness import tasks as JT
from msd_tpu.harness.models import qwen2_vl_msd as JQA
from msd_tpu.harness.models.llava_msd import SimpleTokenizer as JTok
from msd_tpu.models import draft as JD
from msd_tpu.models import qwen2vl as JQ
from msd_tpu.models import qwen2vl_vision as JV
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.engine.generator import MSDGenerator as TGen
from msd_tpu_torch.harness import __main__ as TMain
from msd_tpu_torch.harness import evaluator as TEv
from msd_tpu_torch.harness import registry as TR
from msd_tpu_torch.harness import tasks as TTK
from msd_tpu_torch.harness.instance import Instance
from msd_tpu_torch.harness.models import qwen2_vl_msd as TQA
from msd_tpu_torch.harness.models.llava_msd import SimpleTokenizer
from msd_tpu_torch.models import qwen2vl as TQ
from msd_tpu_torch.models import qwen2vl_vision as TV
from msd_tpu_torch.utils import weights as TW
from tests.test_torch_anyres_multi import jax_native
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_qwen_model import _host, jax_qwen_params
from tests.test_torch_qwen_vision import jax_vision_params

V = 512
QKW = dict(vocab=V, hidden=64, layers=2, heads=4, kv_heads=2, inter=128)
GRID = (4, 4)                      # 56px images: 4 merged rows
TASKS = ["synthetic_vqa", "pope", "ai2d_ppl"]
GEN_KW = {"max_new_tokens": 10}
TREE = dict(top_k=4, max_depth=4, num_nodes=12)


@pytest.fixture(scope="module")
def jax_weights():
    jq = JQ.Qwen2VLTextConfig.tiny(**QKW)
    jtp = jax_qwen_params(jq, seed=2)
    dp = JD.init_draft_params(jax.random.PRNGKey(9),
                              JC.DraftConfig(text=jq.as_llama()))
    dp["embed_tokens"] = jtp["embed_tokens"]
    jvcfg = JV.Qwen2VisionConfig.tiny(hidden=jq.hidden_size)
    jvis = jax_vision_params(jvcfg, seed=4)
    return jtp, dp, jvis


@pytest.fixture(scope="module")
def jax_prep():
    """The JAX package's native image prep loaded, and both task
    registries filled, for the module."""
    jax_native()
    if not JR.TASK_REGISTRY:
        JT.register_builtin_tasks()
    if not TR.TASK_REGISTRY:
        TTK.register_builtin_tasks()


def _engs():
    eng = dict(max_seq_len=384, prompt_pad_multiple=64)
    return (JC.EngineConfig(tree=JC.TreeConfig(**TREE), **eng),
            TC.EngineConfig(tree=TC.TreeConfig(**TREE), **eng))


@pytest.fixture(scope="module")
def adapters(jax_weights, jax_prep):
    """make(use_msd) -> (port adapter, JAX adapter) over the same weights,
    built from their constructors."""
    jtp, dp, jvis = jax_weights
    jq = JQ.Qwen2VLTextConfig.tiny(**QKW)
    tq = TQ.Qwen2VLTextConfig.tiny(**QKW)
    jvcfg = JV.Qwen2VisionConfig.tiny(hidden=jq.hidden_size)
    tvcfg = TV.Qwen2VisionConfig.tiny(hidden=tq.hidden_size)
    je, te = _engs()
    n_img = (GRID[0] // 2) * (GRID[1] // 2)
    common = dict(n_img=n_img, eos_id=2, image_mode="inline",
                  mrope_section=jq.mrope_section)
    jgen = JGen(jtp, dp, jq.as_llama(), JC.DraftConfig(text=jq.as_llama()),
                je, **common)
    tgen = TGen(bridge.to_torch(_host(jtp), "cpu"),
                bridge.to_torch(_host(dp), "cpu"), tq.as_llama(),
                TC.DraftConfig(text=tq.as_llama()), te, device="cpu",
                **common)
    tvis = bridge.to_torch(_host(jvis), "cpu")
    jenc = jax.jit(lambda px: JV.qwen_vision_encode(jvis, jvcfg, px))

    def tenc(px):
        return TV.qwen_vision_encode(tvis, tvcfg, torch.from_numpy(px))

    def make(use_msd=True):
        return (TQA.Qwen2VLMSD(tgen, SimpleTokenizer(V), tenc,
                               img_grid=GRID, use_msd=use_msd),
                JQA.Qwen2VLMSD(jgen, JTok(V), jenc, img_grid=GRID,
                               use_msd=use_msd))
    return make


def _responses(out, task):
    return [s["response"] for s in out["details"][task]["samples"]]


def _same_evaluations(mine, theirs, tasks=TASKS):
    for task in tasks:
        a, b = _responses(mine, task), _responses(theirs, task)
        if task == "ai2d_ppl":
            for x, y in zip(a, b):
                for (lp, g), (jlp, jg) in zip(x, y):
                    assert lp == pytest.approx(jlp, rel=1e-4)
                    assert g == jg
        else:
            assert a == b, task
        assert mine["results"][task].keys() == theirs["results"][task].keys()
    assert mine["msd_stats"] == theirs["msd_stats"]


@pytest.fixture(scope="module")
def plain_runs(adapters):
    out = {}
    for kind, use_msd in (("msd", True), ("ar", False)):
        mine, theirs = adapters(use_msd)
        out[kind] = (TEv.evaluate(mine, TASKS, limit=4, gen_kwargs=GEN_KW),
                     JEv.evaluate(theirs, TASKS, limit=4, gen_kwargs=GEN_KW))
    return out


@pytest.mark.parametrize("kind", ["msd", "ar"])
def test_evaluate_matches_jax(plain_runs, kind):
    """Responses, loglikelihoods and msd_stats of ``evaluate`` on the three
    tasks equal the JAX adapter's."""
    _same_evaluations(*plain_runs[kind])


@pytest.mark.parametrize("task", TASKS)
def test_ar_adapter_gives_the_msd_responses(plain_runs, task):
    """Greedy losslessness through the harness on the inline path."""
    msd, ar = plain_runs["msd"][0], plain_runs["ar"][0]
    assert _responses(ar, task) == _responses(msd, task)
    assert msd["msd_stats"]["accept_steps"] > 0
    assert ar["msd_stats"]["accept_steps"] == 0


def test_loglikelihood_request_matches_jax(adapters):
    """One loglikelihood request with an image and one without: both
    packages' (logprob, is_greedy), and a repeat is bitwise equal."""
    from msd_tpu.harness.instance import Instance as JInstance

    mine, theirs = adapters()
    img = JT._synth_image(0)

    def ll(lm, icls, visual):
        req = icls(request_type="loglikelihood", doc={"image": img},
                   arguments=("Describe.", "blue",
                              (lambda d: [d["image"]]) if visual else None,
                              0, "t", "test"),
                   idx=0, task_name="t", doc_id=0)
        return lm.loglikelihood([req])[0]

    for visual in (True, False):
        got, want = ll(mine, Instance, visual), ll(theirs, JInstance, visual)
        assert got[0] == pytest.approx(want[0], rel=1e-4)
        assert got[1] == want[1]
        assert ll(mine, Instance, visual) == got


def test_from_pretrained_matches_jax(tmp_path, jax_weights, jax_prep):
    """A Qwen2-VL checkpoint written by ``save_qwen2_vl`` (fp32, so the
    JAX loader reads it) and an EAGLE draft by ``save_draft``: both
    packages' ``from_pretrained`` (the byte tokenizer, the tower from the
    checkpoint) give equal evaluations."""
    jtp, dp, jvis = jax_weights
    tq = TQ.Qwen2VLTextConfig.tiny(**QKW)
    tvcfg = TV.Qwen2VisionConfig.tiny(hidden=tq.hidden_size)
    ckpt, ddir = str(tmp_path / "qwen"), str(tmp_path / "draft")
    TW.save_qwen2_vl(bridge.to_torch(_host(jtp), "cpu"),
                     bridge.to_torch(_host(jvis), "cpu"), tq, tvcfg, ckpt,
                     torch.float32)
    TW.save_draft(bridge.to_torch(_host(dp), "cpu"), ddir)
    je, te = _engs()
    mine = TQA.Qwen2VLMSD.from_pretrained(ckpt, ddir, device="cpu", eng=te,
                                          img_grid=GRID)
    theirs = JQA.Qwen2VLMSD.from_pretrained(ckpt, ddir,
                                            dtype=jax.numpy.float32,
                                            eng=je, img_grid=GRID)
    assert mine.gen.params["target"]["lm_head"].dtype == torch.float32
    assert (mine.gen.n_img, mine.gen.eos_id) == (theirs.gen.n_img,
                                                 theirs.gen.eos_id)
    _same_evaluations(TEv.evaluate(mine, TASKS, limit=3, gen_kwargs=GEN_KW),
                      JEv.evaluate(theirs, TASKS, limit=3,
                                   gen_kwargs=GEN_KW))


def test_from_pretrained_tapers_a_medusa_draft(tmp_path, jax_weights):
    """Without ``eng``: ``max_seq_len`` from the model args and, for a
    medusa draft, ``LlavaMSD.from_pretrained``'s tapered tree; the default
    image grid is 24 x 24 patches (144 rows)."""
    from msd_tpu_torch.models import draft as D

    jtp, _, jvis = jax_weights
    tq = TQ.Qwen2VLTextConfig.tiny(**QKW)
    tvcfg = TV.Qwen2VisionConfig.tiny(hidden=tq.hidden_size)
    TW.save_qwen2_vl(bridge.to_torch(_host(jtp), "cpu"),
                     bridge.to_torch(_host(jvis), "cpu"), tq, tvcfg,
                     str(tmp_path / "q"), torch.float32)
    dcfg = TC.DraftConfig(text=tq.as_llama(), medusa_heads=3)
    g = torch.Generator().manual_seed(0)
    dp = D.init_draft_params(dcfg, g, "cpu", torch.float32)
    dp["medusa"] = D.init_medusa_params(dcfg, g, "cpu", torch.float32)
    TW.save_draft(dp, str(tmp_path / "d"))
    lm = TQA.Qwen2VLMSD.from_pretrained(str(tmp_path / "q"),
                                        str(tmp_path / "d"), device="cpu",
                                        max_seq_len=640)
    tree = lm.gen.eng.tree
    assert lm.gen.eng.max_seq_len == 640
    assert tree.medusa_widths == (10, 5, 3, 2) and tree.num_nodes == 21
    assert lm.gen.n_img == 144 and lm.gen.image_mode == "inline"


def test_cli_runs_the_tiny_qwen_stack(capsys):
    """``python -m msd_tpu_torch.harness --model qwen2_vl_msd --model_args
    tiny=true --device cpu``: MSD and AR give the same responses."""
    argv = ["--model", "qwen2_vl_msd", "--model_args", "tiny=true",
            "--device", "cpu", "--tasks", "synthetic_vqa,ai2d_ppl",
            "--limit", "2", "--gen_kwargs", "max_new_tokens=8",
            "--log_samples"]
    msd = TMain.main(argv + ["--use_msd"])
    ar = TMain.main(argv)
    for task in ("synthetic_vqa", "ai2d_ppl"):
        assert _responses(msd, task) == _responses(ar, task)
    assert msd["msd_stats"]["accept_steps"] > 0
    assert "qwen2_vl_msd" in TR.MODEL_REGISTRY and \
        "qwen2_vl" in TR.MODEL_REGISTRY
    capsys.readouterr()


def test_video_without_a_video_encoder_raises(adapters):
    """Videos are ported (tests/test_torch_qwen_video.py), but a video
    visual (frames or a file) sent to an adapter built without a video
    encoder raises, naming ``encode_video_fn`` (Qwen-VL v1, which has no
    video encoder: tests/test_torch_qwen_vl_v1.py)."""
    mine, _ = adapters()
    frames = np.zeros((4, 56, 56, 3), np.uint8)
    req = Instance(request_type="generate_until", doc={},
                   arguments=("Describe.", dict(GEN_KW), lambda d: [frames],
                              0, "t", "test"), idx=0, task_name="t",
                   doc_id=0)
    assert mine.encode_video_fn is None
    with pytest.raises(ValueError, match="encode_video_fn"):
        mine.generate_until([req])
    with pytest.raises(ValueError, match="encode_video_fn"):
        mine.generate_until([Instance(
            request_type="generate_until", doc={},
            arguments=("Describe.", dict(GEN_KW), lambda d: ["clip.mp4"], 0,
                       "t", "test"), idx=0, task_name="t", doc_id=0)])
