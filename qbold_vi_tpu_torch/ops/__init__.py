"""Kernel wrappers with their plain torch versions."""
