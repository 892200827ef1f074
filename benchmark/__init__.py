"""The benchmark of the PyTorch and CUDA port (``bdvcil_torch``) on an NVIDIA H100:
``run.py`` runs one cell once (see ``BENCHMARK.json``)."""
