"""Checkpoints in the reference's format (training itself is not ported
yet)."""
