"""Host-side utilities: meters and the run metrics logger."""
