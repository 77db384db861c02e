"""Measurement tools for the port on a CUDA card."""
