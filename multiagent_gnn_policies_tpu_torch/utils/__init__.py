"""Configuration and checkpoint reading (numpy only)."""
