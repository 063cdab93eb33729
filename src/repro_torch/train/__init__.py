"""Training: the train-step factory and the fault-tolerant loop."""
