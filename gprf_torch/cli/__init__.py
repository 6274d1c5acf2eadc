"""Command-line entry points (mirror of ``gprf_tpu/cli``)."""
