"""PyTorch port of msd_tpu: modality-aware speculative decoding for
vision-language models on an NVIDIA H100.

The JAX package ``msd_tpu`` is the reference. The port keeps its module
names and public tensor layouts, imports nothing from it, and runs every
entry point on ``device="cuda"`` unless the caller passes another device.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """The lazy top-level API, as the JAX package's: ``import
    msd_tpu_torch`` loads no engine module until one of these names is
    read."""
    if name == "MSDGenerator":
        from msd_tpu_torch.engine.generator import MSDGenerator
        return MSDGenerator
    if name == "SamplingParams":
        from msd_tpu_torch.ops.sampling import SamplingParams
        return SamplingParams
    if name in ("LlamaConfig", "LlavaConfig", "DraftConfig", "TreeConfig",
                "EngineConfig", "ClipVisionConfig"):
        import msd_tpu_torch.configs as _c
        return getattr(_c, name)
    raise AttributeError(name)
