"""Multi-device partition rules of the port."""
