"""Problem factories."""
