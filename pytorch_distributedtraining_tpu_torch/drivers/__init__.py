"""Training drivers of the port."""
