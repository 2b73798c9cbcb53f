"""Profiling hooks."""
