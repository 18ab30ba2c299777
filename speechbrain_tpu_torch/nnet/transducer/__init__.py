"""Transducer building blocks (the joint network)."""
