"""The training data pipeline (a numpy-only copy of ``repro.data``)."""
