"""Models of the port (the two-tower recsys model so far)."""
