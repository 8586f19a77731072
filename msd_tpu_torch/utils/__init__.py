"""Host-side utilities of the port: prompt templates and image prep."""
