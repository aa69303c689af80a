"""The policy network and its weight import."""
