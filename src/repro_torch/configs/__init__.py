"""Configuration of the port (the RADS engine config only)."""
