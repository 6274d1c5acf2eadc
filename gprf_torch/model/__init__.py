"""The GPRF objective and the fused per-step evaluation."""
