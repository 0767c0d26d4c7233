"""Parallelism across cards (counterpart of ``cmh_tpu/parallel/``):
``dp`` holds data parallelism, one process per card."""
