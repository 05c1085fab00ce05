"""Serving engine and driver."""
