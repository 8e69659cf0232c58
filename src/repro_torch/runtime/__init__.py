"""Runtime helpers of the port (step watchdog)."""
