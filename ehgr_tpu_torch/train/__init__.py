"""Training: losses, the 9-group SGD policy, the EMA and the train step."""
