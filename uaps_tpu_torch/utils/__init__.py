"""Host-side utilities of the port: config tree, CLI flags, weights, logs."""
