"""Encoder and fine-tuner modules."""
