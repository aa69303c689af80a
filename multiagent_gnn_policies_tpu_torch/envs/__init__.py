"""Flocking environment parameters and initial states."""
