"""The reduced single-model ServerCore."""
