"""Training: the optimizer, the Trainer and its train step."""
