"""The generator model."""
