"""The master's monitors (the error monitor)."""
