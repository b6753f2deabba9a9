"""Seeded synthetic record generators (numpy)."""
