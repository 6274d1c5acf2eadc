"""Synthetic experiment data (mirror of ``gprf_tpu/data``)."""
