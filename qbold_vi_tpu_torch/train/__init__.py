"""Fine-tuning: losses, optimiser, data pipeline, steps and trainer."""
