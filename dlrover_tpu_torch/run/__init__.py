"""Entry scripts of the port."""
