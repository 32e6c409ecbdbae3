"""Models of the port: GPT-2, its training step and the weight converter."""
