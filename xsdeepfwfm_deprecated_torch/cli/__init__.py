"""Command-line entry points, flag for flag the JAX package's. Each ``main`` takes
the argument list and ``device`` (``None``: the CUDA device); ``main_all`` and
``quantization`` also take ``data_dir``, the datasets' root in place of the
repo's ``data/``."""
