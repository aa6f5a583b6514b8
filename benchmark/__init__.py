"""The benchmark of the PyTorch and CUDA port on a CUDA card (see run.py)."""
