"""Utility records and tables."""
