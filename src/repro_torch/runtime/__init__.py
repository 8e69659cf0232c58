"""Runtime helpers of the port: the step watchdog (fault.py) and the
integer gradient wire (compress.py)."""
