"""Results protocol (mirror of ``gprf_tpu/analysis``)."""
