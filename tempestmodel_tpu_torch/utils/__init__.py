"""Host-side utilities of the port: model time, phase timers and
hierarchical announcements."""
