"""Model adapters of the harness; each registers itself on import."""
