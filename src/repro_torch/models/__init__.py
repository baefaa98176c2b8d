"""The decoder stack (dense attention architectures) in PyTorch."""
