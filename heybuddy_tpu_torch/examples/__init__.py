"""Walkthroughs of the port's public API."""
