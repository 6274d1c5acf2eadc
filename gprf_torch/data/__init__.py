"""Experiment data: synthetic and seismic, and the seismic data pipeline (mirror of ``gprf_tpu/data``)."""
