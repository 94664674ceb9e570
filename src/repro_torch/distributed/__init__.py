"""Fault tolerance: the deterministic fault injector of the kill-and-resume
tests."""
