"""The master's node registry and job managers."""
