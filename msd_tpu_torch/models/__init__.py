"""Model functions of the port: LLaMA target, draft head, LLaVA fusion."""
