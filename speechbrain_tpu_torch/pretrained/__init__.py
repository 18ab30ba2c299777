"""Saving trained modules for the inference scripts (``training``)."""
