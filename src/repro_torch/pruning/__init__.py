"""In-situ pruning application of the port (§3.2)."""
