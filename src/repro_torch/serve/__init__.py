"""Serving: paged step factory, sampling, page bookkeeping, batch engine."""
