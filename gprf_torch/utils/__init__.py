"""Helpers around the port."""
