"""Train state, schedules and the train and eval steps (counterpart of stcd_tpu/train)."""
