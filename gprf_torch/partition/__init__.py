"""Host-side block partitioners."""
