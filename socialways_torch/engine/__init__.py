"""Trainer (serving half)."""
