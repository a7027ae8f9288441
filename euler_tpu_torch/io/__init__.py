"""Checkpoints (`checkpoint`)."""
