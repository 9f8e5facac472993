"""Geometry: camera model and depth unprojection."""
