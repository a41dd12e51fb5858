"""Small host utilities (network)."""
