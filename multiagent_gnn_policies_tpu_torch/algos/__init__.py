"""Trainers: imitation (cloning, DAGGER) and the expert baseline."""
