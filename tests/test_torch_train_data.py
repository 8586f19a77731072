"""The port's tokenized and Qwen2-VL training records
(``msd_tpu_torch.train.data_gen``), the trainer's W&B logs and the
profiling utilities (``msd_tpu_torch.utils.profiling``) against the JAX
package's, on tiny fp32 configs on the CPU.

Weights go across through the bridge; conversations, images and features
come from ``np.random.default_rng`` seeds. Ids, masks, lengths and the
files' keys and dtypes must be bitwise equal; float fields within 1e-5
(absolute and relative).
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.harness.models.llava_msd import SimpleTokenizer as JTok
from msd_tpu.models import llama as JL
from msd_tpu.models import qwen2vl as JQ
from msd_tpu.train import data_gen as JG
from msd_tpu.train import trainer as JTR
from msd_tpu.utils import profiling as JP
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.harness.models.llava_msd import SimpleTokenizer
from msd_tpu_torch.models import qwen2vl as TQ
from msd_tpu_torch.train import data_gen as TG
from msd_tpu_torch.train import trainer as TTR
from msd_tpu_torch.utils import profiling as TP
from tests.test_torch_anyres_multi import jax_native
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_train import _draft, _records, _train_cfg

TOL = dict(atol=1e-5, rtol=1e-5)
V, H, N_IMG = 300, 32, 16
TURNS = [[("describe the picture", "a red square on grey"),
          ("and the corner?", "empty")],
         [("hello", "hi there, how can I help")],
         [("count", "one two three"), ("again", "four"), ("last", "five")]]


def _host(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def target():
    kw = dict(vocab_size=V, hidden_size=H, layers=2, heads=4,
              intermediate_size=64, max_pos=1024)
    jcfg, tcfg = JC.LlamaConfig.tiny(**kw), TC.LlamaConfig.tiny(**kw)
    jtp = JL.init_llama_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, jtp, bridge.to_torch(_host(jtp), "cpu")


def _same_record(out, ref):
    assert sorted(out) == sorted(ref)
    for k in ref:
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("with_image", [False, True])
@pytest.mark.parametrize("system", ["", None])
def test_build_conversation_ids_matches_jax(with_image, system):
    kw = {} if system is None else {"system": system}
    for turns in TURNS:
        ids, mask = TG.build_conversation_ids(SimpleTokenizer(V), turns,
                                              with_image, **kw)
        jids, jmask = JG.build_conversation_ids(JTok(V), turns, with_image,
                                                **kw)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(mask, jmask)
        assert ids.dtype == jids.dtype and mask.dtype == jmask.dtype
        assert mask.sum() > 0
        assert (ids == TC.IMAGE_TOKEN_INDEX).sum() == int(with_image)


@pytest.mark.parametrize("image", [False, True])
@pytest.mark.parametrize("pad_to", [96, 320])
def test_make_training_record_matches_jax(target, image, pad_to):
    """pad_to 96 cuts the default-system conversation inside its replies."""
    jcfg, tcfg, jtp, ttp = target
    feats = np.random.default_rng(5).normal(size=(N_IMG, H)) \
        .astype(np.float32) * 0.1
    kw = dict(n_img=N_IMG if image else 0, pad_to=pad_to)
    ref = JG.make_training_record(jtp, jcfg, JTok(V), TURNS[0],
                                  img_feats=jnp.asarray(feats) if image
                                  else None, **kw)
    out = TG.make_training_record(ttp, tcfg, SimpleTokenizer(V), TURNS[0],
                                  img_feats=torch.from_numpy(feats) if image
                                  else None, **kw)
    _same_record(out, ref)
    assert out["img_mask"].sum() == (N_IMG if image else 0)


def _pixels_encoder(w):
    """A stand-in image encoder, the same on both sides: the CLIP-normalized
    [3, 336, 336] pixels sampled every 84 rows and columns (16 rows of 3
    channels) times ``w`` [3, H]."""

    def jenc(px):
        return px[:, ::84, ::84].reshape(3, 16).T @ jnp.asarray(w)

    def tenc(px):
        return px[:, ::84, ::84].reshape(3, 16).T @ torch.from_numpy(w)
    return jenc, tenc


def test_generate_dataset_writes_jax_records(target, tmp_path):
    """Four samples (an image array, text, a second image, and one whose
    replies ``pad_to`` cuts away, which both skip) through the same
    stand-in encoder: the same files, keys, dtypes and values. Both
    packages' image prep runs its default (native C++) path."""
    jax_native()
    jcfg, tcfg, jtp, ttp = target
    rng = np.random.default_rng(9)
    img = [rng.integers(0, 256, size=(40 + 20 * i, 60, 3), dtype=np.uint8)
           for i in range(2)]
    samples = [{"turns": TURNS[0], "image": img[0]},
               {"turns": TURNS[1], "image": None},
               {"turns": TURNS[2], "image": img[1]},
               {"turns": [("x" * 400, "late answer")], "image": None}]
    jenc, tenc = _pixels_encoder(rng.normal(size=(3, H)).astype(np.float32)
                                 * 0.1)
    kw = dict(n_img=N_IMG, pad_to=256)
    n_j = JG.generate_dataset(jtp, jcfg, JTok(V), samples,
                              str(tmp_path / "j"), encode_image_fn=jenc, **kw)
    n_t = TG.generate_dataset(ttp, tcfg, SimpleTokenizer(V), samples,
                              str(tmp_path / "t"), encode_image_fn=tenc, **kw)
    assert n_t == n_j == 3
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    for name in names:
        _same_record(dict(np.load(tmp_path / "t" / name)),
                     dict(np.load(tmp_path / "j" / name)))
    # the shard [start, end) writes only its samples
    assert TG.generate_dataset(ttp, tcfg, SimpleTokenizer(V), samples,
                               str(tmp_path / "s"), encode_image_fn=tenc,
                               start=1, end=3, **kw) == 2
    assert sorted(os.listdir(tmp_path / "s")) == names[1:]


@pytest.fixture(scope="module")
def qwen():
    """A tiny Qwen2-VL LM with q/k/v biases drawn non-zero, both sides."""
    jq = JQ.Qwen2VLTextConfig.tiny(vocab=V, hidden=H, layers=2, heads=4,
                                   kv_heads=2, inter=64)
    tq = TQ.Qwen2VLTextConfig.tiny(vocab=V, hidden=H, layers=2, heads=4,
                                   kv_heads=2, inter=64)
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    jp = JQ.init_qwen2_params(k1, jq)
    for i, name in enumerate(("q_bias", "k_bias", "v_bias")):
        jp["layers"][name] = 0.1 * jax.random.normal(
            jax.random.fold_in(k2, i), jp["layers"][name].shape)
    return jq, tq, jp, bridge.to_torch(_host(jp), "cpu")


@pytest.mark.parametrize("image", [False, True])
def test_qwen_records_match_jax(qwen, image):
    """qwen_teacher_forward and make_qwen_record_from_ids: a 2x3 merged
    grid inline after five text tokens (mrope positions), or text only."""
    jq, tq, jp, tp = qwen
    rng = np.random.default_rng(12)
    grid, n_img = (2, 3), 6
    ids = rng.integers(3, V, size=30).astype(np.int32)
    feats = rng.normal(size=(n_img, H)).astype(np.float32) * 0.1
    if image:
        ids[4] = TQ.VISION_START_ID
        ids[5:5 + n_img] = TQ.IMAGE_PAD_ID
        ids[5 + n_img] = TQ.VISION_END_ID
    mask = np.zeros(len(ids), np.float32)
    mask[14:] = 1.0
    jf = jnp.asarray(feats) if image else None
    tf = torch.from_numpy(feats) if image else None
    g = grid if image else None
    ref = JG.qwen_teacher_forward(jp, jq, ids, jf, 5, n_img if image
                                  else 0, g, 40)
    out = TG.qwen_teacher_forward(tp, tq, ids, tf, 5, n_img if image else 0,
                                  g, 40)
    _same_record(out, ref)
    ref = JG.make_qwen_record_from_ids(jp, jq, ids, mask, 40, img_feats=jf,
                                       grid_hw=g)
    out = TG.make_qwen_record_from_ids(tp, tq, ids, mask, 40, img_feats=tf,
                                       grid_hw=g)
    _same_record(out, ref)
    assert out["img_mask"].sum() == (n_img if image else 0)


class _FakeWandb:
    """A stand-in ``wandb`` module: ``init`` returns a run that records
    every ``log`` call."""

    def __init__(self):
        self.logs = []
        self.inits = []

    def module(self):
        mod = types.ModuleType("wandb")
        fake = self

        class Run:
            def log(self, metrics, step=None):
                fake.logs.append((step, dict(metrics)))

            def finish(self):
                pass

        def init(project=None, name=None, config=None):
            fake.inits.append((project, config))
            return Run()

        mod.init = init
        return mod


def test_trainer_logs_to_wandb_as_jax_does(monkeypatch):
    """train/* every log_every steps and epoch/* per epoch, at JAX's steps
    and keys and with its values (within the trainer tests' 2e-5)."""
    monkeypatch.delenv("WANDB_MODE", raising=False)
    jd, td, jp, tp, head = _draft()
    jtc, ttc = _train_cfg(warmup_steps=1)
    kw = dict(batch_size=2, max_len=24, num_epochs=2, log_every=1,
              wandb_project="msd-test")
    logs = {}
    for side in ("jax", "torch"):
        fake = _FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake.module())
        if side == "jax":
            tr = JTR.DraftTrainer(jd, jp, jnp.asarray(head),
                                  JTR.TrainerConfig(train=jtc, **kw))
        else:
            tr = TTR.DraftTrainer(td, tp, torch.from_numpy(head),
                                  TTR.TrainerConfig(train=ttc, **kw), "cpu")
        for _ in range(2):
            tr.run_epoch(_records()[:2], _records()[2:], log=lambda *a: None)
        assert [p for p, _ in fake.inits] == ["msd-test"]
        logs[side] = fake.logs
    assert [(s, sorted(m)) for s, m in logs["torch"]] == \
        [(s, sorted(m)) for s, m in logs["jax"]]
    assert any(k.startswith("train/") for _, m in logs["torch"] for k in m)
    assert any(k.startswith("epoch/") for _, m in logs["torch"] for k in m)
    for (_, mt), (_, mj) in zip(logs["torch"], logs["jax"]):
        for k in mj:
            if k != "epoch/seconds":
                assert mt[k] == pytest.approx(mj[k], rel=2e-5, abs=2e-5), k


def test_trainer_without_wandb_logs_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)   # import fails
    _, td, _, tp, head = _draft()
    _, ttc = _train_cfg()
    tr = TTR.DraftTrainer(td, tp, torch.from_numpy(head),
                          TTR.TrainerConfig(train=ttc, batch_size=2,
                                            max_len=24, log_every=1,
                                            wandb_project="p"), "cpu")
    assert tr.wandb is not None and tr.wandb.run is None
    tr.run_epoch([], _records()[2:], log=lambda *a: None)


def test_step_stats_match_jax():
    rng = np.random.default_rng(2)
    mine, theirs = TP.StepStats(), JP.StepStats()
    for _ in range(5):
        kw = dict(prompt_tokens=int(rng.integers(5, 50)),
                  new_tokens=int(rng.integers(1, 30)),
                  steps=int(rng.integers(1, 10)),
                  acc_sum=int(rng.integers(1, 40)),
                  hist=rng.integers(0, 5, size=int(rng.integers(1, 6))))
        mine.update(**kw)
        theirs.update(**kw)
    assert mine.summary() == theirs.summary()
    assert TP.StepStats().summary() == JP.StepStats().summary()


def test_timer_time_fn_and_trace_run_on_the_cpu(tmp_path):
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    seen = []
    with TP.Timer("mm", sync_on=x, log=seen.append) as tm:
        y = x @ x
    assert tm.elapsed > 0 and seen and seen[0].startswith("[Timer] mm:")
    assert TP.time_fn(lambda a: a @ a, x, repeats=2) > 0
    with TP.trace(str(tmp_path / "tr")) as prof:
        (y @ x).sum()
    assert prof is not None
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
