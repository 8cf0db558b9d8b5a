"""Data-parallel training and multi-process evaluation (counterpart of
``hgsfusion_tpu/parallel``): one process per card under ``torchrun``."""
