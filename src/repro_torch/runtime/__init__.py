"""Serve engines."""
