"""Tracing, timing and finiteness helpers of the port."""
