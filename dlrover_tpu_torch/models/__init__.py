"""Models of the port (Llama-3 family)."""
