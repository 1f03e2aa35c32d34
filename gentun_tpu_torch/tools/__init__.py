"""Measurement tools for the port; each needs a CUDA device."""
