"""Serving surface of the port: continuous batching, the HTTP front end
and the chat CLI."""
