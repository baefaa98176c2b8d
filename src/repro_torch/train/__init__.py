"""Step functions of the decoder: training and serving."""
