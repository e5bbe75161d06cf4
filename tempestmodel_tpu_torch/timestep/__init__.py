"""Time-stepping schemes of the port (the IMEX-ARK tableaux so far)."""
