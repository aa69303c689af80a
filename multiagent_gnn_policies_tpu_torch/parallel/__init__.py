"""Large-N rollouts on one device."""
