"""Geometry: camera model, depth unprojection, train-time augmentation."""
