"""One reader per per-layer metric (`<metric>.py`, found by name), and the
cost functions they share (`costs.py`)."""
