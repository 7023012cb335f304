"""Configuration, I/O and guard utilities."""
