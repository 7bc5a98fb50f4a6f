"""Training: the optimizer zoo and the one shared trainer."""
