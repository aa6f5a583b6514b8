"""User-script plugin host of the port (host code)."""
