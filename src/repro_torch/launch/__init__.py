"""Entry points: batched serving and training."""
