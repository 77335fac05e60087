"""Measurement helpers for the card."""
