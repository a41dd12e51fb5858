"""Failure diagnosis: worker log classification."""
