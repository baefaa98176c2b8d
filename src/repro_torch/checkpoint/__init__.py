"""Fault-tolerant checkpointing of training state (``manager``)."""
