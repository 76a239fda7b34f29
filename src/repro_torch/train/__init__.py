"""Training: the train step (loss -> gradients -> clip -> AdamW) and the
fault-tolerant loop."""
