"""Training: the loss, the train step and the work-shared trainer."""
