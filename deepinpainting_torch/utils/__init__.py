"""Host-side utilities: metrics and their logger, image IO and grids,
profiling, parameter counts."""
