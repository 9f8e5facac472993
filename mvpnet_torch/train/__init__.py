"""Batch preparation and metrics."""
