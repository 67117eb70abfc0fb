"""Elementwise ops of the DDC chain: phase ramps, NCO, fast LO."""
