"""Dataset-specific task utilities (the lmms-eval tasks/*/utils.py layer)."""
