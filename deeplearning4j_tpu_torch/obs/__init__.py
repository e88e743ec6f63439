"""Observability (slice 3: the metrics registry)."""
