"""Functional layers: nested dicts of tensors, ``(params, x) -> y``."""
