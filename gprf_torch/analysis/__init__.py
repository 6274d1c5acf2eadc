"""Results protocol, figure data, plots and the run fleet (mirror of ``gprf_tpu/analysis``)."""
