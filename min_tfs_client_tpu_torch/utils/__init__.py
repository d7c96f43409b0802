"""Status codes and errors."""
