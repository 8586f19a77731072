"""Tensor ops of the port: norms, rope, attention, sampling and the CUDA
decode-attention kernel."""
