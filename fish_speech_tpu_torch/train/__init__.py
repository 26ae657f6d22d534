"""Training-side functions of the port (the forward half only, for now)."""
