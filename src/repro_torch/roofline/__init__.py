"""Analytic per-device cost model of one distributed step (``analytic``)."""
