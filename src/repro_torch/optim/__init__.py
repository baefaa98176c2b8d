"""Optimizers of the training path: AdamW (``adamw``) and error-feedback
int8 gradient compression (``compress``)."""
