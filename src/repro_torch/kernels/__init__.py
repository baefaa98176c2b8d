"""Hand-written GPU kernels of the port (``{kernel,ops,ref}`` per kernel)."""
