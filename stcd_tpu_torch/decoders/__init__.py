"""Decoders of the port (counterpart of stcd_tpu/decoders)."""
