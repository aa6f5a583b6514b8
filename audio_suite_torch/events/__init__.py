"""Event-field schedulers of the port (host code)."""
