"""Host-side utilities of the port: weight loading and the serving CLI."""
