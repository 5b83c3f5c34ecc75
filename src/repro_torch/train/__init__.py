"""Training: the synthetic token stream, AdamW with its schedules, and the
loop with checkpoints and rollback."""
