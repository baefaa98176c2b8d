"""Step functions of the decoder (serving; training comes later)."""
