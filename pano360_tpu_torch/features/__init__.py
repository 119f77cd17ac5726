"""Feature extraction (SIFT)."""
