"""Training: the learning-rate schedule, the optimizer and the train and eval steps."""
