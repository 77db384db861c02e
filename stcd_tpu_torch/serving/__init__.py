"""Micro-batching inference server (counterpart of stcd_tpu/serving)."""
