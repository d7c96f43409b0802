"""Request handlers and the in-process LocalServer."""
