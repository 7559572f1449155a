"""Weight bridge and NIfTI I/O."""
