"""The port's training entry point (``python -m msd_tpu_torch.train``) and
distill -> evaluate pipeline (``train/pipeline.py``) against the JAX
package's, on the CPU, and the smoke's ``[train]`` phase at tiny size.

The CLI runs its four subcommands in process with ``--device cpu`` on a
tiny HF-layout checkpoint (``tests/test_weights_roundtrip.
make_llava_checkpoint``, the counterpart of its ``test_train_cli_end_to_
end``); ``finetune`` writes the JAX CLI's keys and shapes. The pipeline's
on-policy records equal JAX's on one set of tiny weights carried across
(the harness tests' stack): ids and masks bitwise, float fields within
1e-5.
"""

import json
import os

import numpy as np
import pytest
import torch

from msd_tpu.harness.models.llava_msd import LlavaMSD as JLlavaMSD
from msd_tpu.harness.registry import get_task as jget_task
from msd_tpu.train import pipeline as JPipe
from msd_tpu_torch import configs as TC
from msd_tpu_torch.harness.evaluator import evaluate
from msd_tpu_torch.harness.models.llava_msd import LlavaMSD
from msd_tpu_torch.harness.registry import get_task
from msd_tpu_torch.train import __main__ as TM
from msd_tpu_torch.train import pipeline as TPipe
from msd_tpu_torch.utils import weights as W
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_harness import stack  # noqa: F401 (fixture)
from tests.test_weights_roundtrip import make_llava_checkpoint

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    make_llava_checkpoint(str(root / "ckpt"), np.random.default_rng(0))
    data = [{"conversations": [
        {"from": "human", "value": f"<image>\nquestion {i}"},
        {"from": "gpt", "value": f"answer {i} with words"},
        {"from": "human", "value": "and more?"},
        {"from": "gpt", "value": f"more {i}"}]} for i in range(4)]
    (root / "instruct.json").write_text(json.dumps(data))
    return root


def test_cli_subcommands_run_on_the_cpu(ckpt, tmp_path):
    """gen-data, fit, finetune and pipeline through ``main`` with
    ``--device cpu``: the records, fit's loadable export, and finetune's
    ``finetuned.npz`` with the keys and shapes of the JAX CLI's on the
    same checkpoint and data."""
    from msd_tpu.train.__main__ import main as jmain

    base, data = str(ckpt / "ckpt"), str(ckpt / "instruct.json")
    recs = tmp_path / "recs"
    n = TM.main(["gen-data", "--device", "cpu", "--basepath", base,
                 "--data", data, "--outdir", str(recs), "--no-image",
                 "--pad-to", "320"])
    assert n == 4 and len(list(recs.glob("rec_*.npz"))) == 4
    trainer = TM.main(["fit", "--device", "cpu", "--basepath", base,
                       "--tmpdir_t", str(recs),
                       "--cpdir", str(tmp_path / "cp"),
                       "--epochs", "1", "--bs", "2", "--max-len", "320"])
    assert trainer.step_count == 2
    params, lcfg = W.load_llava(base, torch.float32, "cpu")
    draft, _ = W.load_draft(str(tmp_path / "cp" / "export"), lcfg.text,
                            base_embed=params["target"]["embed_tokens"],
                            dtype=torch.float32, device="cpu")
    assert torch.equal(draft["fc_w"], trainer.params["fc_w"].detach())
    assert os.path.exists(tmp_path / "cp" / "epoch_1" / "state.pt")

    args = ["finetune", "--basepath", base, "--data", data, "--no-image",
            "--pad-to", "320", "--bs", "2"]
    ft = TM.main(args + ["--device", "cpu", "--cpdir", str(tmp_path / "ft")])
    assert ft.step_count == 2
    jmain(args + ["--cpdir", str(tmp_path / "jft")])
    mine = np.load(tmp_path / "ft" / "finetuned.npz")
    theirs = np.load(tmp_path / "jft" / "finetuned.npz")
    assert sorted(mine.keys()) == sorted(theirs.keys())
    for k in theirs.keys():
        assert mine[k].shape == theirs[k].shape and \
            mine[k].dtype == theirs[k].dtype == np.float32, k

    lm, out = TM.main(["pipeline", "--device", "cpu", "--tiny", "--tasks",
                       "synthetic_vqa", "--distill-docs", "2",
                       "--distill-steps", "4", "--limit", "2",
                       "--log-dir", str(tmp_path / "pipe")])
    assert out["msd_stats"]["accept_steps"] > 0
    assert os.path.exists(tmp_path / "pipe" / "acceptance_rate.json")


def test_cli_defaults_to_the_card():
    """Without --device every subcommand asks for cuda (the JAX flags plus
    --device)."""
    for argv in (["fit", "--basepath", "x"],
                 ["gen-data", "--basepath", "x", "--data", "d", "--outdir",
                  "o"],
                 ["finetune", "--basepath", "x", "--data", "d"],
                 ["pipeline", "--tasks", "t"]):
        assert TM.parse_args(argv).device == "cuda"
        assert TM.parse_args(argv + ["--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("msd_trajectories", [True, False])
def test_collect_onpolicy_records_matches_jax(stack,  # noqa: F811
                                              msd_trajectories):
    mine, theirs = stack(LlavaMSD, JLlavaMSD)
    kw = dict(max_new=12, log=lambda *a: None,
              msd_trajectories=msd_trajectories)
    ref = JPipe.collect_onpolicy_records(theirs, jget_task("synthetic_vqa"),
                                         3, **kw)
    out = TPipe.collect_onpolicy_records(mine, get_task("synthetic_vqa"), 3,
                                         **kw)
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.shape == y.shape and x.dtype == y.dtype, k
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, y, err_msg=k, **TOL)
            else:
                np.testing.assert_array_equal(x, y, err_msg=k)


def test_distill_and_eval_raises_alpha(tmp_path):
    """The counterpart of tests/test_training.py's pipeline test: on-policy
    records, draft training, the draft installed by ``set_draft`` (the
    generator's graphs over the old draft released) and evaluated."""
    lm = LlavaMSD.from_tiny(device="cpu", log_dir=str(tmp_path))
    before = evaluate(lm, ["synthetic_vqa"],
                      limit=4)["msd_stats"]["avg_accept_len"]
    old = lm.gen.params["draft"]
    out = TPipe.distill_and_eval(lm, ["synthetic_vqa"], distill_docs=6,
                                 distill_steps=150, distill_max_new=24,
                                 limit=4, log=lambda *a: None)
    after = out["msd_stats"]["avg_accept_len"]
    assert after > before + 0.1, f"alpha did not improve: {before} -> {after}"
    new = lm.gen.params["draft"]
    assert new is not old and new["embed_tokens"] is old["embed_tokens"]
    assert os.path.exists(tmp_path / "acceptance_rate.json")
    assert "synthetic_vqa" in out["results"]


def test_smoke_train_phase_at_tiny_size(tmp_path):
    """``chip_smoke.run_train`` on a tiny seeded checkpoint (a 336-pixel
    tower of 16 patches, as ``generate_dataset`` prepares images at 336):
    every gate of the phase, the frozen-LM gate rejecting the planted
    fault, K1 never launched."""
    import chip_smoke

    lcfg = TC.LlavaConfig(
        text=TC.LlamaConfig.tiny(vocab_size=512, hidden_size=64, layers=2,
                                 heads=4, intermediate_size=128,
                                 max_pos=2048),
        vision=TC.ClipVisionConfig.tiny(hidden_size=32, layers=2, heads=4,
                                        image_size=336, patch_size=84,
                                        intermediate_size=64))
    chip_smoke.seeded_checkpoint(str(tmp_path / "ckpt"), lcfg, device="cpu")
    out = chip_smoke.run_train(str(tmp_path / "ckpt"), str(tmp_path),
                               device="cpu", fit_lr=0.2, pipe_docs=2,
                               pipe_steps=8, pipe_limit=2, max_new=12)
    assert out["fit_steps"] == 19
    assert out["fit_loss"][1] < out["fit_loss"][0]
    assert out["planted_moved"] > 0
    assert out["ft1_recompute"][2] <= 1e-5
    assert (out["launches"], out["captured"]) == (0, 0)
