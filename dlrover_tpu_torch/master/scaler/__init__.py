"""Scalers: execute a ScalePlan against the platform."""
