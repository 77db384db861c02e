"""Losses of the port (counterpart of stcd_tpu/losses)."""
