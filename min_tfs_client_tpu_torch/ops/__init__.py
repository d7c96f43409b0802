"""Attention: the hand-written Hopper kernel and its plain version."""
