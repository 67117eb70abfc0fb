"""Pipelines of the port: the BASELINE configurations #1-#5."""
