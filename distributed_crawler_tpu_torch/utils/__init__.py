"""Host-side utilities of the port: metrics, tracing, occupancy, cost."""
