"""Serving steps of the port."""
