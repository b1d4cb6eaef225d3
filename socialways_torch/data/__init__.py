"""numpy-only data layer (copies of socialways_tpu/data)."""
