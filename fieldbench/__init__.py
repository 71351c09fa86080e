"""The benchmark of the PyTorch and CUDA port ``nifty_tpu_torch``: a
data-driven harness (``run.py``), the plain reference that decides
``correct`` (``reference/``), the frozen work counts behind the rooflines
(``work/``), and each cell's configuration, traffic mix, limits and
per-layer readers as files of their own."""
