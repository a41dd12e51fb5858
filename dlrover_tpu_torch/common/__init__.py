"""Own copies of the stdlib-only helpers the port needs (flags, log, device)."""
