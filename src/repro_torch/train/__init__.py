"""Training sessions, schedules and checkpoints in the reference's
format."""
