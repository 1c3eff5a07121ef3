"""Process-wide helpers of the port (the device warm-up)."""
