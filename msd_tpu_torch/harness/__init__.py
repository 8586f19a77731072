"""The eval harness of the port (the lmms-eval layer): tasks, metrics,
the evaluator, the LLaVA adapters and ``python -m msd_tpu_torch.harness``."""
