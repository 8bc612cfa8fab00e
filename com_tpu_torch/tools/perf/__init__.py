"""Performance sweeps of the port, run on the card."""
