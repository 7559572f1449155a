"""Posterior distribution transforms."""
