"""Ternary codes, 2-bit packing and the serving weight container."""
