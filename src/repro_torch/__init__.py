"""PyTorch + CUDA port of the FARSI reproduction (see README.md)."""
