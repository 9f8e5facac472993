"""Whole-scene evaluation."""
