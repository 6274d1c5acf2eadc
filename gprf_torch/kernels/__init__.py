"""Covariance functions: hyperparameters, distances and profiles."""
