"""Entry points: batched serving."""
