"""Signatures, servables and the platform loader."""
