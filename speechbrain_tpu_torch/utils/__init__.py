"""Host-side utilities: edit distance, metric accumulation, padding."""
