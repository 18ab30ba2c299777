"""Model architectures."""
