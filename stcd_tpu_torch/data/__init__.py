"""Host-side data helpers for serving (counterpart of stcd_tpu/data)."""
