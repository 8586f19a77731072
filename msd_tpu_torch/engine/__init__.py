"""Decode engine of the port: draft tree, speculative engine, generator."""
