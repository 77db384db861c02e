"""Metrics of the port (counterpart of stcd_tpu/metrics)."""
