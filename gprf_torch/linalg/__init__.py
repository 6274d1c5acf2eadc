"""Padding-safe masked Gaussian log-densities."""
