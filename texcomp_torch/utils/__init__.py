"""Auxiliary helpers: timing on the card."""
