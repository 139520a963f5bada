"""Utilities shared by the port."""
