"""Models built on the port's Fluid API."""
