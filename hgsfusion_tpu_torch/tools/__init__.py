"""Command-line entry points of the port (counterparts of the repository's
``tools/``), run as ``python -m hgsfusion_tpu_torch.tools.<name>``."""
