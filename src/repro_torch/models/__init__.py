"""The decoder stack (attention and Mamba-2 architectures) in PyTorch."""
