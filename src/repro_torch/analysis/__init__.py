"""Shared message text for runtime errors (the static analyzer itself is a
later slice of the port)."""
