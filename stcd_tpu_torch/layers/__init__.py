"""Layers shared by the models (counterpart of stcd_tpu/layers)."""
