"""Training observability (counterpart of stcd_tpu/utils)."""
