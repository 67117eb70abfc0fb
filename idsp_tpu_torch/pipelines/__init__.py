"""Pipelines of the port: BASELINE #5, the wideband DDC bank."""
