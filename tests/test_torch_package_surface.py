"""The port's package surface against the JAX package's: the lazy
top-level names of ``msd_tpu_torch`` (``msd_tpu/__init__.py``'s
``__getattr__``) and ``DraftConfig.tiny``."""

import dataclasses
import subprocess
import sys

import pytest

import msd_tpu
from msd_tpu import configs as JC

import msd_tpu_torch
from msd_tpu_torch import configs as TC

CONFIGS = ("LlamaConfig", "LlavaConfig", "DraftConfig", "TreeConfig",
           "EngineConfig", "ClipVisionConfig")


def test_top_level_names_resolve_to_the_submodules_objects():
    from msd_tpu_torch.engine.generator import MSDGenerator
    from msd_tpu_torch.ops.sampling import SamplingParams

    assert msd_tpu_torch.MSDGenerator is MSDGenerator
    assert msd_tpu_torch.SamplingParams is SamplingParams
    for name in CONFIGS:
        assert getattr(msd_tpu_torch, name) is getattr(TC, name), name
    assert msd_tpu_torch.__version__ == msd_tpu.__version__
    with pytest.raises(AttributeError):
        msd_tpu_torch.NoSuchName


def test_import_alone_loads_no_engine_module():
    """``import msd_tpu_torch`` loads none of its submodules, nor torch;
    reading a config name loads the configs alone."""
    code = ("import sys, msd_tpu_torch; a = sorted(m for m in sys.modules "
            "if m.startswith(('msd_tpu_torch.', 'torch'))); "
            "msd_tpu_torch.DraftConfig; b = sorted(m for m in sys.modules "
            "if m.startswith('msd_tpu_torch.')); print(a, b)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[] ['msd_tpu_torch.configs']"


# the port's two documented default departures (msd_tpu_torch/configs.py):
# field -> (JAX's default, the port's)
DEPARTURES = {"attn_impl": ("xla", "auto"), "pallas_min_s": (1024, 0)}


def _fields_equal(t, j) -> None:
    """Every field of the port's config has JAX's value, nested configs
    field by field, but for the two departures, which hold JAX's and the
    port's defaults."""
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(a):
            _fields_equal(a, b)
        elif f.name in DEPARTURES:
            assert (b, a) == DEPARTURES[f.name], f.name
        else:
            assert a == b, f.name


def test_draft_config_tiny_equals_jax():
    t, j = TC.DraftConfig.tiny(), JC.DraftConfig.tiny()
    _fields_equal(t, j)
    assert t.text == TC.LlamaConfig.tiny() and t.medusa_heads == 0
    assert t != TC.DraftConfig()
