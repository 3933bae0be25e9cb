"""The synchronous Byzantine training loop."""
