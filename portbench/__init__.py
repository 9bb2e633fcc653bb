"""The benchmark of the PyTorch and CUDA port: see ``__main__.py``."""
