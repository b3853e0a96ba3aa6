"""Train state, optimizer and schedules, the train step and its metrics,
checkpoints."""
