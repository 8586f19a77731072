"""PyTorch port of msd_tpu: modality-aware speculative decoding for
vision-language models on an NVIDIA H100.

The JAX package ``msd_tpu`` is the reference. The port keeps its module
names and public tensor layouts, imports nothing from it, and runs every
entry point on ``device="cuda"`` unless the caller passes another device.
"""
