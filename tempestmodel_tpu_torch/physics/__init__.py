"""Physics packages run as workflow processes of the driver."""
