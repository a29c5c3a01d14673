"""Timing, report and checks."""
