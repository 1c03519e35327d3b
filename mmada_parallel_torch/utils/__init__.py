"""Host-side utilities: image preprocessing, logging/metrics."""
