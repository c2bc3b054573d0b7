"""Helpers the CLI's modes share (the reference's `modes/`)."""
