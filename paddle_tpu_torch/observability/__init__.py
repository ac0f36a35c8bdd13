"""Telemetry of the PyTorch port: the metrics registry, tracing, the
flight recorder and the step cost accounting (``cost``: FLOPs and MFU)."""
