"""Feature front ends and model lobes."""
