"""Optimizers over the fused loss."""
