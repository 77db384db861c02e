"""Models (counterpart of stcd_tpu/models)."""
